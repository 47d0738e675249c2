"""Single-carrier DPSK: the low-SNR floor waveform (125-31.25 baud).

Reference: src/psk/dpsk.hpp (header-only, 1169 lines).  Batched redesign:

* symbol correlation at ALL offsets is one FFT matched filter against the
  single-carrier analytic template (the reference slides an O(L) loop);
* the Barker-13x3 differential preamble search evaluates every coarse offset
  in parallel from the gathered symbol-grid correlations;
* demodulateSoft is a shifted-multiply differential chain (no scan needed).

Preserved semantics: DQPSK steps (2v+1)*45 deg (dpsk.hpp:80-84), D8PSK
v*45+22.5 deg, raised-cosine pulse shaping on data symbols only, preamble at
full amplitude with continuous carrier phase, confidence = min(10*|diff|, 5),
sin-based LLRs (dpsk.hpp:1000-1053).
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np

BARKER13 = np.array([1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1], np.int32)
PREAMBLE_REPEATS = 3
DPSK_TRAINING_SYMBOLS = 8
DETECTION_THRESHOLD = 0.80
GLOBAL_OUTLIER_RATIO = 1.3
MIN_SYMBOL_ENERGY = 0.001


class DPSKModulation(enum.IntEnum):
    DBPSK = 0
    DQPSK = 1
    D8PSK = 2


@dataclasses.dataclass(frozen=True)
class DPSKConfig:
    """(dpsk.hpp:42-99)"""
    sample_rate: float = 48000.0
    carrier_freq: float = 1500.0
    samples_per_symbol: int = 1536
    modulation: DPSKModulation = DPSKModulation.DQPSK
    rolloff: float = 0.35
    use_pulse_shaping: bool = True

    @property
    def bits_per_symbol(self) -> int:
        return {DPSKModulation.DBPSK: 1, DPSKModulation.DQPSK: 2,
                DPSKModulation.D8PSK: 3}[self.modulation]

    @property
    def symbol_rate(self) -> float:
        return self.sample_rate / self.samples_per_symbol

    @property
    def preamble_symbols(self) -> int:
        return len(BARKER13) * PREAMBLE_REPEATS

    @property
    def preamble_samples(self) -> int:
        return self.preamble_symbols * self.samples_per_symbol

    def phase_increment(self, v: np.ndarray) -> np.ndarray:
        """Differential phase step per symbol value (dpsk.hpp:75-89)."""
        v = np.asarray(v)
        if self.modulation == DPSKModulation.DBPSK:
            return np.where(v > 0, np.pi, 0.0).astype(np.float32)
        if self.modulation == DPSKModulation.DQPSK:
            return ((v * 2 + 1) * np.pi / 4.0).astype(np.float32)
        return ((v & 7) * np.pi / 4.0 + np.pi / 8.0).astype(np.float32)


# Presets (dpsk.hpp:1064-1169).
def robust(): return DPSKConfig(modulation=DPSKModulation.DBPSK, samples_per_symbol=1536)
def low_snr(): return DPSKConfig(modulation=DPSKModulation.DBPSK, samples_per_symbol=768)
def medium(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=768)
def fast(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=384)
def turbo(): return DPSKConfig(modulation=DPSKModulation.D8PSK, samples_per_symbol=384)
def high_speed(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=192)
def speed1(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=160)
def speed2(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=128)
def speed3(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=96)
def speed4(): return DPSKConfig(modulation=DPSKModulation.D8PSK, samples_per_symbol=128)
def max_speed(): return DPSKConfig(modulation=DPSKModulation.D8PSK, samples_per_symbol=64)


@functools.lru_cache(maxsize=None)
def _carrier(cfg: DPSKConfig):
    """cos / sin tables for one symbol (carrier phase restarts each symbol —
    every preset has an integer number of carrier cycles per symbol)."""
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = 2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pulse_shape(cfg: DPSKConfig) -> np.ndarray:
    """Raised-cosine envelope 0.5*(1 - cos(2*pi*t/N)) (dpsk.hpp:281-293)."""
    if not cfg.use_pulse_shaping:
        return np.ones(cfg.samples_per_symbol, np.float32)
    t = np.arange(cfg.samples_per_symbol, dtype=np.float64) / cfg.samples_per_symbol
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * t))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def generate_preamble(cfg: DPSKConfig) -> np.ndarray:
    """Barker-13 x3 DBPSK at full amplitude, continuous carrier
    (dpsk.hpp:108-149)."""
    cos_t, _ = _carrier(cfg)
    sym_phase = np.cumsum(np.where(np.tile(BARKER13, PREAMBLE_REPEATS) < 0,
                                   np.pi, 0.0))
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = 2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate
    out = np.cos(ph[None, :] + sym_phase[:, None]).astype(np.float32)
    return out.reshape(-1)


@functools.lru_cache(maxsize=None)
def generate_training(cfg: DPSKConfig) -> np.ndarray:
    """8 alternating 0/180-deg DBPSK symbols (dpsk.hpp:175-200)."""
    sym_phase = np.where(np.arange(DPSK_TRAINING_SYMBOLS) % 2 == 0, 0.0, np.pi)
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = 2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate
    return np.cos(ph[None, :] + sym_phase[:, None]).astype(np.float32).reshape(-1)


@functools.lru_cache(maxsize=None)
def generate_reference(cfg: DPSKConfig) -> np.ndarray:
    """Single 0-deg reference symbol (dpsk.hpp:155-172)."""
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    return np.cos(2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate
                  ).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("cfg", "initial_symbol_phase"))
def modulate(cfg: DPSKConfig, bits: jnp.ndarray,
             initial_symbol_phase: float = 0.0) -> jnp.ndarray:
    """[B, nbits] -> [B, S*L] pulse-shaped differential PSK.

    initial_symbol_phase: symbol phase carried over from the preamble
    (after Barker x3 the accumulated phase is 6 pi = 0 mod 2 pi; after
    training it is pi)."""
    B, nbits = bits.shape
    bc = cfg.bits_per_symbol
    S = -(-nbits // bc)
    bits = jnp.pad(bits.astype(jnp.int32), ((0, 0), (0, S * bc - nbits)))
    w = (bits.reshape(B, S, bc)
         * (1 << jnp.arange(bc - 1, -1, -1, dtype=jnp.int32))).sum(-1)
    steps = jnp.asarray(cfg.phase_increment(np.arange(2 ** bc)))[w]
    theta = initial_symbol_phase + jnp.cumsum(steps, axis=1)  # [B, S]

    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = (2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate).astype(np.float32)
    env = jnp.asarray(_pulse_shape(cfg))
    out = env[None, None, :] * jnp.cos(jnp.asarray(ph)[None, None, :]
                                       + theta[:, :, None])
    return out.reshape(B, S * cfg.samples_per_symbol)


def correlate_symbols(cfg: DPSKConfig, samples: jnp.ndarray) -> jnp.ndarray:
    """[..., S*L] -> [..., S] complex symbol correlations
    (correlateSymbol, dpsk.hpp:777-789: I = mean s*cos, Q = -mean s*sin)."""
    cos_t, sin_t = _carrier(cfg)
    L = cfg.samples_per_symbol
    S = samples.shape[-1] // L
    x = samples[..., :S * L].reshape(*samples.shape[:-1], S, L)
    I = x @ jnp.asarray(cos_t) / L
    Q = -(x @ jnp.asarray(sin_t)) / L
    return (I + 1j * Q).astype(jnp.complex64)


@functools.partial(jax.jit, static_argnames=("cfg",))
def demodulate_soft(cfg: DPSKConfig, data: jnp.ndarray, prev: jnp.ndarray,
                    cfo_hz=0.0, initial_phase_offset=0.0) -> jnp.ndarray:
    """demodulateSoft (dpsk.hpp:822-878): differential decode with CFO/initial
    phase compensation; confidence = min(10*|diff|, 5); sin-based LLRs."""
    corr = correlate_symbols(cfg, data)                  # [..., S]
    prev_chain = jnp.concatenate([prev[..., None], corr[..., :-1]], axis=-1)
    diff = corr * jnp.conj(prev_chain)
    mag = jnp.abs(diff)
    phase = jnp.angle(diff)

    cfo = jnp.asarray(cfo_hz, jnp.float32)
    ipo = jnp.asarray(initial_phase_offset, jnp.float32)
    compensate = (jnp.abs(cfo) > 0.5) | (jnp.abs(ipo) > 0.01)
    cfo_phase = 2.0 * np.pi * cfo * cfg.samples_per_symbol / cfg.sample_rate
    comp = phase - cfo_phase[..., None] - ipo[..., None]
    comp = jnp.mod(comp + np.pi, 2 * np.pi) - np.pi
    phase = jnp.where(compensate[..., None], comp, phase)

    conf = jnp.minimum(mag * 10.0, 5.0)
    phase = jnp.where(phase < 0, phase + 2 * np.pi, phase)

    if cfg.modulation == DPSKModulation.DBPSK:
        llrs = (conf * jnp.cos(phase))[..., None]
    elif cfg.modulation == DPSKModulation.DQPSK:
        llrs = jnp.stack([conf * jnp.sin(phase),
                          conf * jnp.sin(2.0 * phase)], axis=-1)
    else:
        llrs = jnp.stack([conf * jnp.sin(phase), conf * jnp.sin(2.0 * phase),
                          conf * jnp.sin(4.0 * phase)], axis=-1)
    return llrs.reshape(*llrs.shape[:-2], -1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_cfo_from_training(cfg: DPSKConfig, training: jnp.ndarray) -> jnp.ndarray:
    """(dpsk.hpp:902-950): average deviation of the +pi alternating pattern."""
    corr = correlate_symbols(cfg, training)
    d = corr[..., 1:] * jnp.conj(corr[..., :-1])
    valid = (jnp.abs(corr[..., 1:]) >= 0.01) & (jnp.abs(corr[..., :-1]) >= 0.01)
    err = jnp.angle(d) - np.pi
    err = jnp.mod(err + np.pi, 2 * np.pi) - np.pi
    cnt = jnp.maximum(valid.sum(-1), 1)
    avg = jnp.where(valid, err, 0.0).sum(-1) / cnt
    avg = jnp.where(valid.sum(-1) > 0, avg, 0.0)
    sym_dur = cfg.samples_per_symbol / cfg.sample_rate
    return avg / (2.0 * np.pi * sym_dur)


@functools.partial(jax.jit, static_argnames=("cfg",))
def set_reference_with_training(cfg: DPSKConfig, training: jnp.ndarray,
                                ref: jnp.ndarray):
    """(dpsk.hpp:955-1000) -> (prev_symbol, cfo_hz, initial_phase_offset)."""
    cfo = estimate_cfo_from_training(cfg, training)
    corr = correlate_symbols(cfg, training)
    last, prev = corr[..., -1], corr[..., -2]
    d = last * jnp.conj(prev)
    measured = jnp.angle(d)
    cfo_phase = 2.0 * np.pi * cfo * cfg.samples_per_symbol / cfg.sample_rate
    ipo = measured - cfo_phase - np.pi
    ipo = jnp.mod(ipo + np.pi, 2 * np.pi) - np.pi
    ok = (jnp.abs(prev) > 0.01) & (jnp.abs(last) > 0.01)
    ipo = jnp.where(ok, ipo, 0.0)
    prev_symbol = correlate_symbols(cfg, ref)[..., 0]
    return prev_symbol, cfo, ipo


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_preamble_snr_db(cfg: DPSKConfig, preamble_samples: jnp.ndarray,
                             cfo_hz) -> jnp.ndarray:
    """Post-correlation SNR from the Barker preamble symbols: LS fit of one
    complex gain against the known 0/pi phase pattern (CFO-derotated with
    the caller's estimate), residual = noise.  Feeds mode negotiation the
    way MC-DPSK's estimate_snr_db does; the reference has no single-carrier
    SNR estimator (its engine never RXes this waveform), so this follows
    channel_equalizer.cpp:221 getEstimatedSNR semantics instead."""
    corr = correlate_symbols(cfg, preamble_samples)        # [..., n_sym]
    n = cfg.preamble_symbols
    sym_phase = np.cumsum(np.where(np.tile(BARKER13, PREAMBLE_REPEATS) < 0,
                                   np.pi, 0.0)).astype(np.float32)
    p = jnp.exp(1j * jnp.asarray(sym_phase))
    i = jnp.arange(n, dtype=jnp.float32)
    w = (2.0 * np.pi * jnp.asarray(cfo_hz, jnp.float32)[..., None]
         * cfg.samples_per_symbol / cfg.sample_rate)
    z = corr[..., :n] * jnp.exp(-1j * w * i) * jnp.conj(p)
    # Residual-rotation self-refinement: a small error in the caller's CFO
    # estimate rotates z across the preamble and would smear h toward zero;
    # measure the per-symbol rotation differentially and remove it.
    d = z[..., 1:] * jnp.conj(z[..., :-1])
    w_res = jnp.angle(d.mean(-1))
    z = z * jnp.exp(-1j * w_res[..., None] * i)
    h = z.mean(-1)
    resid = z - h[..., None]
    snr = jnp.abs(h) ** 2 / jnp.maximum((jnp.abs(resid) ** 2).mean(-1), 1e-12)
    return 10.0 * jnp.log10(jnp.clip(snr, 1e-3, 1e5))


@functools.partial(jax.jit, static_argnames=("cfg", "max_search_symbols"))
def find_preamble(cfg: DPSKConfig, samples: jnp.ndarray,
                  max_search_symbols: int = 156, valid_len=None):
    """Batched CFO-tolerant Barker-13x3 differential preamble search
    (findPreamble, dpsk.hpp:339-480).

    Evaluates the differential pattern score at every sample offset in
    [0, max_search) using an FFT matched filter for the per-offset symbol
    correlations — denser than the reference's coarse+fine search.

    valid_len ([B] or scalar, dynamic): number of REAL samples in a
    zero-padded streaming buffer.  Offsets whose preamble would extend past
    it are masked out — a partially-arrived preamble scores ~37/38 on the
    differential pattern and would otherwise be accepted with a corrupted
    last (reference) symbol and a skewed CFO estimate.

    Returns (found [B] bool, data_start [B] int32, cfo_hz [B],
    initial_phase_offset [B], prev_symbol [B] complex64).
    """
    B, T = samples.shape
    L = cfg.samples_per_symbol
    n_sym = cfg.preamble_symbols
    pre_n = cfg.preamble_samples

    # Per-offset symbol correlation via FFT matched filter.
    cos_t, sin_t = _carrier(cfg)
    tmpl = (cos_t - 1j * sin_t).astype(np.complex64)  # e^{-j w i}
    n_fft = 1 << int(T - 1).bit_length()
    S = jnp.fft.fft(samples.astype(jnp.complex64), n=n_fft, axis=-1)
    Tf = jnp.fft.fft(jnp.conj(jnp.asarray(tmpl)), n=n_fft)
    corr_all = jnp.fft.ifft(S * jnp.conj(Tf), axis=-1)[:, :T - L + 1] / L

    max_search = min(max_search_symbols * L, T - pre_n)
    offs = jnp.arange(max_search)
    sym_idx = offs[:, None] + jnp.arange(n_sym)[None, :] * L   # [O, n_sym]
    syms = corr_all[:, sym_idx]                                # [B, O, n_sym]

    # Differential pattern score (computeDifferentialScore, dpsk.hpp:487-546).
    expected = np.tile(BARKER13, PREAMBLE_REPEATS)[1:]          # 38 diffs
    diff = syms[..., 1:] * jnp.conj(syms[..., :-1])
    mag = jnp.abs(diff)
    dn = jnp.where(mag > 1e-10, diff / jnp.maximum(mag, 1e-30), 0.0)
    score = jnp.abs((dn * jnp.asarray(expected, np.float32)).sum(-1)) / len(expected)
    total_energy = (jnp.abs(syms) ** 2).sum(-1)
    score = jnp.where(total_energy >= MIN_SYMBOL_ENERGY * n_sym, score, 0.0)
    if valid_len is not None:
        vl = jnp.asarray(valid_len, jnp.int32).reshape(-1, 1)  # [B or 1, 1]
        score = jnp.where(offs[None, :] + pre_n <= vl, score, 0.0)

    # EARLIEST qualifying preamble wins, not the globally strongest: with
    # two frames in one buffer a global argmax can lock onto the later
    # (marginally stronger) one and the engine's consume-through-frame
    # would discard the earlier frame (same rule as
    # chirp.detect_dual_chirp).  Two candidate rules, A/B-resolved like the
    # chirp detector:
    #   A: earliest above the ABSOLUTE threshold whose score also dominates
    #      its own Barker 13/26-symbol-shift sidelobes — keeps a genuinely
    #      weak (faded) early frame sitting below 85% of a later stronger
    #      preamble (the sidelobe-dominance check rejects the 26/39-match
    #      self-similarity lobe that fires 13 symbols EARLY);
    #   B: earliest within 85% of the global max — the round-2 rule, robust
    #      when A's crossing is a noise spike that fails the final gates.
    # A wins when it fully validates; otherwise fall back to B.
    idxb = jnp.arange(B)
    gmax = score.max(-1)
    global_avg = score[:, ::L].mean(-1)  # coarse-grid average, like the C++
    rel = jnp.arange(-L, L + 1)

    def _resolve(strong):
        first = jnp.argmax(strong, axis=-1).astype(jnp.int32)
        widx = jnp.clip(first[:, None] + rel[None, :], 0, score.shape[-1] - 1)
        wsc = score[idxb[:, None], widx]
        b = widx[idxb, jnp.argmax(wsc, axis=-1)].astype(jnp.int32)
        bs = score[idxb, b]
        f = strong.any(-1) & (bs >= DETECTION_THRESHOLD) & \
            (bs >= global_avg * GLOBAL_OUTLIER_RATIO)
        return f, b

    n13 = 13 * L

    def _shift(k):
        # score at offset o+k; out-of-range reads as -1 (never dominates).
        return jnp.concatenate(
            [score[:, k:], jnp.full((B, min(k, score.shape[-1])), -1.0)],
            axis=-1)[:, :score.shape[-1]]

    dominated = (score < _shift(n13)) | (score < _shift(2 * n13))
    found_a, best_a = _resolve((score >= DETECTION_THRESHOLD) & ~dominated)
    found_b, best_b = _resolve(
        score >= jnp.maximum(DETECTION_THRESHOLD, 0.85 * gmax[:, None]))
    best = jnp.where(found_a, best_a, best_b)
    found = found_a | found_b

    # CFO estimate from the matched differentials (estimateCFOTolerant).
    sy = syms[idxb, best]                                        # [B, n_sym]
    d = sy[:, 1:] * jnp.conj(sy[:, :-1])
    dmag = jnp.abs(d)
    dn = jnp.where(dmag > 1e-30, d / jnp.maximum(dmag, 1e-30), 0.0)
    csum = (dn * jnp.asarray(expected, np.float32)).sum(-1)
    sym_dur = L / cfg.sample_rate
    cfo = -jnp.angle(csum) / (2.0 * np.pi * sym_dur)

    # Initial phase offset from first 10 differentials.
    k = min(10, len(expected))
    dphase = jnp.angle(dn[:, :k])
    exp_ph = np.where(expected[:k] > 0, 0.0, np.pi).astype(np.float32)
    cfo_phase = (2.0 * np.pi * cfo * L / cfg.sample_rate)[:, None]
    errs = jnp.mod(dphase - cfo_phase - exp_ph + np.pi, 2 * np.pi) - np.pi
    ipo = errs.mean(-1)

    # Matched-filter timing refinement for the near-zero-CFO case
    # (refineTimingWithMatchedFilter, dpsk.hpp:709-770): normalized real
    # correlation against the first 6 preamble symbols, searched +-1 symbol
    # around the coarse peak.
    REFINE_SYMBOLS = 6
    tmpl6 = generate_preamble(cfg)[:REFINE_SYMBOLS * L]
    t6_energy = float((tmpl6 ** 2).sum())
    T6 = jnp.fft.fft(jnp.asarray(tmpl6).astype(jnp.complex64), n=n_fft)
    mf = jnp.fft.ifft(S * jnp.conj(T6), axis=-1).real[:, :T - REFINE_SYMBOLS * L + 1]
    # Block-stable sliding energy (not a global f32 cumsum difference — the
    # precision trap documented in CLAUDE.md for >50k-sample buffers).
    from projectultra.sync.schmidl_cox import _window_sum
    e6 = _window_sum(samples * samples, REFINE_SYMBOLS * L)
    nmf = jnp.where(e6 * t6_energy > 1e-20,
                    jnp.abs(mf) / jnp.sqrt(jnp.maximum(e6 * t6_energy, 1e-30)),
                    0.0)
    p6 = jnp.arange(nmf.shape[-1])[None, :]
    win = (p6 >= (best - L)[:, None]) & (p6 <= (best + L)[:, None])
    if valid_len is not None:
        # The refine window must honor the same mask as the coarse search:
        # without it the refined peak can slide up to L samples past the
        # real prefix, putting the re-gathered reference symbol window into
        # the zero padding (the exact corruption valid_len exists to stop).
        win = win & (p6 + pre_n <= vl)
    refined = jnp.argmax(jnp.where(win, nmf, -1.0), axis=-1).astype(jnp.int32)
    best = jnp.where(jnp.abs(cfo) < 0.5, refined, best)

    # Re-gather the reference symbol (last preamble symbol) at the refined
    # position (findPreamble sets prev_symbol_ there, dpsk.hpp:466-472).
    ref_off = best + (n_sym - 1) * L
    prev_symbol = corr_all[idxb, jnp.clip(ref_off, 0, corr_all.shape[-1] - 1)]

    data_start = best + pre_n
    return found, data_start, cfo, ipo, prev_symbol
