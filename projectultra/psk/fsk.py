"""BFSK + adaptive 2-32-tone MFSK: the very-low-SNR fallback waveforms.

Reference: src/fsk/fsk.hpp (BFSK 31.25 baud, 50 Hz separation, 4x bit
repetition) and src/fsk/mfsk.hpp (adaptive MFSK, Goertzel tone detection,
tone-sweep preamble, repetition combining, power-ratio LLRs).  Note the
waveform factory maps MFSK -> MC-DPSK in the reference
(waveform_factory.cpp:33-36 — MFSK is deprecated); this module keeps both
cores for inventory parity.

Design notes: the reference's per-sample Goertzel loops become one
[.., L] x [L, T] tone-basis matmul per symbol batch (identical unscaled
|DFT|^2 powers); the preamble search computes tone powers once for ALL
L/4-strided windows and scores every candidate offset in parallel instead
of the two-stage scalar scan."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import mixer as mixer_ops


@dataclasses.dataclass(frozen=True)
class FSKConfig:
    """(fsk.hpp:21-33)"""
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    freq_separation: float = 50.0
    samples_per_symbol: int = 1536
    repetition: int = 4

    @property
    def mark_freq(self) -> float:
        return self.center_freq + self.freq_separation / 2

    @property
    def space_freq(self) -> float:
        return self.center_freq - self.freq_separation / 2


@functools.lru_cache(maxsize=None)
def _tone_tables(cfg: FSKConfig):
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64) / cfg.sample_rate
    mark = np.cos(2 * np.pi * cfg.mark_freq * i).astype(np.float32)
    space = np.cos(2 * np.pi * cfg.space_freq * i).astype(np.float32)
    mark_iq = np.exp(-2j * np.pi * cfg.mark_freq * i).astype(np.complex64)
    space_iq = np.exp(-2j * np.pi * cfg.space_freq * i).astype(np.complex64)
    return mark, space, mark_iq, space_iq


def generate_preamble(cfg: FSKConfig, num_symbols: int = 16) -> np.ndarray:
    """Alternating space/mark tones (fsk.hpp:42-51)."""
    mark, space, _, _ = _tone_tables(cfg)
    syms = [mark if (i % 2 == 1) else space for i in range(num_symbols)]
    return np.concatenate(syms)


@functools.partial(jax.jit, static_argnames=("cfg",))
def modulate(cfg: FSKConfig, bits: jnp.ndarray) -> jnp.ndarray:
    """[B, nbits] -> [B, nbits*rep*sps]: each bit repeated `repetition` times,
    mark = 1, space = 0."""
    mark, space, _, _ = _tone_tables(cfg)
    rep = jnp.repeat(bits.astype(jnp.float32), cfg.repetition, axis=-1)
    out = (rep[..., None] * jnp.asarray(mark)[None, None, :]
           + (1.0 - rep[..., None]) * jnp.asarray(space)[None, None, :])
    return out.reshape(bits.shape[0], -1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def demodulate_soft(cfg: FSKConfig, samples: jnp.ndarray) -> jnp.ndarray:
    """Noncoherent tone discrimination + repetition combining:
    LLR > 0 => bit 0 (space)."""
    _, _, mark_iq, space_iq = _tone_tables(cfg)
    L = cfg.samples_per_symbol
    S = samples.shape[-1] // L
    x = samples[..., :S * L].reshape(*samples.shape[:-1], S, L).astype(jnp.complex64)
    e_mark = jnp.abs(x @ jnp.asarray(mark_iq)) / L
    e_space = jnp.abs(x @ jnp.asarray(space_iq)) / L
    per_sym = (e_space - e_mark) * 40.0          # + => space => bit 0
    nbits = S // cfg.repetition
    comb = per_sym[..., :nbits * cfg.repetition].reshape(
        *per_sym.shape[:-1], nbits, cfg.repetition).sum(-1)
    return jnp.clip(comb, -10.0, 10.0)

# ---------------------------------------------------------------------------
# Adaptive MFSK (mfsk.hpp) — 2/4/8/16/32 tones, tone-sweep preamble,
# noncoherent Goertzel-power detection, repetition combining.
# ---------------------------------------------------------------------------

MFSK_MIN_ENERGY = 1.0            # mfsk.hpp:187 (coarse gate; *0.5 in fine)
MFSK_MIN_DOMINANCE = 0.2         # mfsk.hpp:190
MFSK_SCORE_THRESHOLD = 0.6       # mfsk.hpp:268
MFSK_VALID_FRACTION = 0.3        # mfsk.hpp:258 (>= 30% symbols with energy)


@dataclasses.dataclass(frozen=True)
class MFSKConfig:
    """(mfsk.hpp:25-58)"""
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    tone_spacing: float = 50.0
    num_tones: int = 8           # 2, 4, 8, 16, or 32
    samples_per_symbol: int = 1536
    repetition: int = 2

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.num_tones))

    @property
    def symbol_rate(self) -> float:
        return self.sample_rate / self.samples_per_symbol

    @property
    def raw_bps(self) -> float:
        return self.symbol_rate * self.bits_per_symbol

    @property
    def effective_bps(self) -> float:
        return self.raw_bps / self.repetition

    def tone_freq(self, tone_idx: int) -> float:
        off = (tone_idx - (self.num_tones - 1) / 2.0) * self.tone_spacing
        return self.center_freq + off

    def preamble_samples(self, cycles: int = 2) -> int:
        return cycles * self.num_tones * self.samples_per_symbol


# SNR presets (mfsk_presets, mfsk.hpp:545-582).
def mfsk_robust():  return MFSKConfig(num_tones=2, repetition=4)   # ~30 bps
def mfsk_low_snr(): return MFSKConfig(num_tones=4, repetition=3)   # ~45 bps
def mfsk_medium():  return MFSKConfig(num_tones=8, repetition=2)   # ~62 bps
def mfsk_fast():    return MFSKConfig(num_tones=16, repetition=2)  # ~94 bps
def mfsk_turbo():   return MFSKConfig(num_tones=32, repetition=1)  # ~156 bps


@functools.lru_cache(maxsize=None)
def _mfsk_tables(cfg: MFSKConfig):
    """Tone DFT basis as separate cos/sin [L, T] f32 + per-tone
    per-symbol phase steps."""
    L, T = cfg.samples_per_symbol, cfg.num_tones
    freqs = np.array([cfg.tone_freq(t) for t in range(T)], np.float64)
    n = np.arange(L, dtype=np.float64)[:, None] / cfg.sample_rate
    w = 2 * np.pi * freqs[None, :] * n
    basis_c = np.cos(w).astype(np.float32)
    basis_s = np.sin(w).astype(np.float32)
    dphi = (2 * np.pi * freqs * L / cfg.sample_rate).astype(np.float32)
    return freqs.astype(np.float32), basis_c, basis_s, dphi


def mfsk_tone_powers(cfg: MFSKConfig, syms: jnp.ndarray) -> jnp.ndarray:
    """[..., L] -> [..., T] unscaled |DFT|^2 at the tone bins — numerically
    the Goertzel power of mfsk.hpp:523-538 (same unscaled definition)."""
    _, bc, bs, _ = _mfsk_tables(cfg)
    c = syms @ jnp.asarray(bc)
    s = syms @ jnp.asarray(bs)
    return c * c + s * s


def mfsk_preamble_tones(cfg: MFSKConfig, cycles: int = 2) -> np.ndarray:
    """Tone sweep 0..T-1 repeated `cycles` times (generatePreamble)."""
    return np.tile(np.arange(cfg.num_tones, dtype=np.int32), cycles)


@functools.partial(jax.jit, static_argnames=("cfg",))
def mfsk_modulate_tones(cfg: MFSKConfig, tones: jnp.ndarray) -> jnp.ndarray:
    """[B, S] tone indices -> [B, S*L] float32 passband with CONTINUOUS
    phase across symbol boundaries (modulateTone keeps a running phase_,
    mfsk.hpp:123-135)."""
    freqs, _, _, dphi = _mfsk_tables(cfg)
    L = cfg.samples_per_symbol
    f = jnp.asarray(freqs)[tones]                       # [B, S]
    step = jnp.asarray(dphi)[tones]                     # [B, S]
    phase0 = jnp.cumsum(step, axis=-1) - step           # phase at symbol start
    t = jnp.arange(L, dtype=jnp.float32) / cfg.sample_rate
    ph = phase0[..., None] + 2 * np.pi * f[..., None] * t[None, None, :]
    return jnp.sin(ph).reshape(tones.shape[0], -1)


def mfsk_generate_preamble(cfg: MFSKConfig, cycles: int = 2) -> np.ndarray:
    tones = mfsk_preamble_tones(cfg, cycles)[None, :]
    return np.asarray(mfsk_modulate_tones(cfg, jnp.asarray(tones)))[0]


def mfsk_bits_to_tones(cfg: MFSKConfig, bits: np.ndarray) -> np.ndarray:
    """[B, nbits] -> [B, S] tone indices, MSB first, each symbol repeated
    `repetition` times (mfsk.hpp:84-120)."""
    bps = cfg.bits_per_symbol
    B, nbits = bits.shape
    n_sym = -(-nbits // bps)
    padded = np.zeros((B, n_sym * bps), bits.dtype)
    padded[:, :nbits] = bits
    weights = (1 << np.arange(bps - 1, -1, -1)).astype(np.int32)
    tones = (padded.reshape(B, n_sym, bps).astype(np.int32) * weights).sum(-1)
    return np.repeat(tones, cfg.repetition, axis=-1)


def mfsk_modulate(cfg: MFSKConfig, bits) -> jnp.ndarray:
    return mfsk_modulate_tones(cfg, jnp.asarray(
        mfsk_bits_to_tones(cfg, np.asarray(bits))))


@functools.partial(jax.jit, static_argnames=("cfg", "cycles"))
def mfsk_find_preamble(cfg: MFSKConfig, samples: jnp.ndarray,
                       cycles: int = 2, valid_len=None):
    """Batched tone-sweep preamble search (findPreamble, mfsk.hpp:173-283).

    Tone powers are computed ONCE for every L/4-strided window; every
    candidate offset then scores its expected sweep by gathering from that
    grid.  Gates preserved: per-symbol energy >= MIN_ENERGY*0.5 to count as
    valid, >=30% valid symbols, tone-error kernel 1/0.5/0.25, final score
    >= 0.6.  (The reference's stage-1 dominance gate only prunes candidates
    — the parallel search needs no pruning, and keeping only the fine gates
    cannot reject more than the reference does.)

    valid_len ([B] or scalar, dynamic): number of REAL samples in a
    zero-padded streaming buffer.  Offsets whose preamble would extend past
    it are masked out — a partially-arrived sweep can clear the 30%-valid
    and 0.6-score gates (the clamped window grid reuses the last window),
    yielding a data_start whose data has not arrived yet.

    Returns (found [B] bool, data_start [B] int32) — data_start is the
    first sample AFTER the preamble, matching the DPSK interface."""
    B, T = samples.shape
    L = cfg.samples_per_symbol
    step = L // 4
    n_sym = cycles * cfg.num_tones
    pre_len = n_sym * L
    max_search = min(T - pre_len, 2 * pre_len)
    if max_search < 0:
        return jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32)
    K = (T - L) // step + 1
    idx = jnp.arange(K)[:, None] * step + jnp.arange(L)[None, :]
    wins = samples[:, idx]                              # [B, K, L]
    powers = mfsk_tone_powers(cfg, wins)                # [B, K, T]

    n_off = max_search // step + 1
    offs = jnp.arange(n_off)                            # offset = offs*step
    sym_win = offs[:, None] + jnp.arange(n_sym)[None, :] * 4   # [O, n_sym]
    sym_win = jnp.minimum(sym_win, K - 1)
    p = powers[:, sym_win, :]                           # [B, O, n_sym, T]

    total = p.sum(-1)
    best = jnp.argmax(p, axis=-1)                       # [B, O, n_sym]
    expected = jnp.asarray(mfsk_preamble_tones(cfg, cycles))[None, None, :]
    err = jnp.abs(best - expected)
    kernel = jnp.where(err == 0, 1.0,
                       jnp.where(err == 1, 0.5, jnp.where(err == 2, 0.25, 0.0)))
    valid = total > MFSK_MIN_ENERGY * 0.5
    score = jnp.where(valid, kernel, 0.0).sum(-1) / n_sym       # [B, O]
    enough = valid.sum(-1) >= int(np.ceil(n_sym * MFSK_VALID_FRACTION))
    score = jnp.where(enough, score, 0.0)
    if valid_len is not None:
        vl = jnp.asarray(valid_len, jnp.int32).reshape(-1, 1)   # [B or 1, 1]
        score = jnp.where(offs[None, :] * step + pre_len <= vl, score, 0.0)

    best_o = jnp.argmax(score, axis=-1)
    best_score = jnp.take_along_axis(score, best_o[:, None], 1)[:, 0]
    found = best_score >= MFSK_SCORE_THRESHOLD
    data_start = (best_o * step + pre_len).astype(jnp.int32)
    return found, data_start


@functools.partial(jax.jit, static_argnames=("cfg",))
def mfsk_demodulate_soft(cfg: MFSKConfig, samples: jnp.ndarray,
                         cfo_hz=None) -> jnp.ndarray:
    """[B, n_sym*rep*L] aligned at data start -> [B, n_sym*bits] LLRs.
    Repetition powers combine by SUM before the power-ratio LLR
    (demodulateSoft + tonePowersToLLR, mfsk.hpp:318-520); positive LLR =
    bit 0.  cfo_hz ([B]) derotates before the tone basis — equivalent to
    updateGoertzelForCFO's shifted detection frequencies."""
    B, T = samples.shape
    L, rep = cfg.samples_per_symbol, cfg.repetition
    n_sym = T // (rep * L)
    x = samples[:, :n_sym * rep * L]
    if cfo_hz is not None:
        t = jnp.arange(x.shape[-1], dtype=jnp.float32) / cfg.sample_rate
        w = 2 * np.pi * jnp.asarray(cfo_hz, jnp.float32)[:, None] * t[None, :]
        # Shift the received tones DOWN by cfo (x * e^{-jw}) so a tone
        # transmitted at f and received at f+cfo lands back on the static
        # detection basis at f — equivalent to updateGoertzelForCFO's
        # detection at f+cfo.  (Sign pinned by test_mfsk's estimate->demod
        # wiring test; the original +jw derotation DOUBLED the offset.)
        xc = x * jnp.cos(w) - 1j * (x * jnp.sin(w))
        syms = xc.reshape(B, n_sym, rep, L)
        _, bc, bs, _ = _mfsk_tables(cfg)
        c = jnp.real(syms) @ jnp.asarray(bc) + jnp.imag(syms) @ jnp.asarray(bs)
        s = -jnp.real(syms) @ jnp.asarray(bs) + jnp.imag(syms) @ jnp.asarray(bc)
        p = (c * c + s * s).sum(2)
    else:
        syms = x.reshape(B, n_sym, rep, L)
        p = mfsk_tone_powers(cfg, syms).sum(2)          # [B, n_sym, T]

    bps = cfg.bits_per_symbol
    tones = np.arange(cfg.num_tones)
    llrs = []
    for b in range(bps):
        mask = 1 << (bps - 1 - b)
        m1 = jnp.asarray((tones & mask) != 0)
        p1 = jnp.where(m1[None, None, :], p, 0.0).sum(-1)
        p0 = jnp.where(m1[None, None, :], 0.0, p).sum(-1)
        llrs.append(jnp.log((p0 + 1e-10) / (p1 + 1e-10)))
    llr = jnp.stack(llrs, axis=-1).reshape(B, -1)
    return jnp.clip(llr, -10.0, 10.0)


@functools.partial(jax.jit, static_argnames=("cfg", "cycles"))
def mfsk_estimate_cfo(cfg: MFSKConfig, samples: jnp.ndarray,
                      preamble_start: jnp.ndarray, cycles: int = 2):
    """Parabolic-interpolated CFO from the preamble sweep
    (estimateCFO, mfsk.hpp:415-470): power at f, f±spacing/2 per expected
    tone symbol, log-domain parabolic peak, mean over confident symbols."""
    B, T = samples.shape
    L = cfg.samples_per_symbol
    n_sym = cycles * cfg.num_tones
    expected = mfsk_preamble_tones(cfg, cycles)
    freqs = np.array([cfg.tone_freq(t) for t in expected], np.float64)
    half = cfg.tone_spacing * 0.5

    idx = (preamble_start[:, None, None]
           + jnp.arange(n_sym)[None, :, None] * L
           + jnp.arange(L)[None, None, :])
    idx = jnp.clip(idx, 0, T - 1)
    syms = samples[jnp.arange(B)[:, None, None], idx]   # [B, n_sym, L]

    n = np.arange(L, dtype=np.float64)[:, None] / cfg.sample_rate
    out = []
    for df in (-half, 0.0, half):
        w = 2 * np.pi * (freqs[None, :] + df) * n        # [L, n_sym]
        bc = jnp.asarray(np.cos(w).astype(np.float32))
        bs = jnp.asarray(np.sin(w).astype(np.float32))
        c = jnp.einsum("bsl,ls->bs", syms, bc)
        s = jnp.einsum("bsl,ls->bs", syms, bs)
        out.append(c * c + s * s)
    p_lo, p_c, p_hi = out
    db_lo, db_c, db_hi = (jnp.log(jnp.maximum(q, 1e-12)) for q in out)
    denom = db_lo - 2 * db_c + db_hi
    x = 0.5 * (db_lo - db_hi) / jnp.where(jnp.abs(denom) > 1e-3, denom, 1e9)
    ferr = x * half
    okmask = ((jnp.maximum(jnp.maximum(p_lo, p_c), p_hi) >= 0.01)
              & (jnp.abs(ferr) < half) & (jnp.abs(denom) > 1e-3))
    cnt = okmask.sum(-1)
    cfo = jnp.where(cnt >= 3,
                    jnp.where(okmask, ferr, 0.0).sum(-1) / jnp.maximum(cnt, 1),
                    0.0)
    return cfo.astype(jnp.float32)
