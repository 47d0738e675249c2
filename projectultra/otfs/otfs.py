"""OTFS (Orthogonal Time Frequency Space) modem, batched on device.

Reference: src/otfs/otfs.cpp + include/ultra/otfs.hpp.  The delay-Doppler <->
time-frequency transforms are two batched FFTs (the reference's hand-rolled
radix-2 loops, otfs.cpp:16-130):

  ISFFT: tf[n,m] = FFT_M_k( unscaled-IFFT_N_l( dd[k,l] ) )
  SFFT:  dd[k,l] = unscaled-IFFT_M_m( FFT_N_n( tf[n,m] ) ) / (M*N)

Frame layout per codeword (modem_engine.cpp:421-455): [preamble: 4x sync
OFDM symbol, RMS-normalized to 0.1][N data OFDM symbols], carriers on FFT
bins 1..M (positive frequencies, DC skipped), CP 64, mixer reset at both the
preamble start and the data start.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Modulation, bits_per_symbol
from ..ofdm import constellations as con
from ..ops import mixer as mixer_ops

REAL_TO_COMPLEX_SCALE = 2.4     # single-sideband extraction gain (otfs.cpp:150)
PREAMBLE_TARGET_RMS = 0.1
MAX_LLR = 30.0
MIN_LLR_MAG = 0.001
QAM16_THRESHOLD = 0.6324555320336759
FIXED_DD_NOISE_VAR = 0.1        # post-normalization LLR scale (otfs.cpp:728-733)
INTER_FRAME_GAP = 480           # between codeword frames (modem_engine.cpp:433)


@dataclasses.dataclass(frozen=True)
class OTFSConfig:
    """(otfs.hpp:32-58)"""
    M: int = 32               # delay bins (subcarriers)
    N: int = 16               # Doppler bins (OFDM symbols per frame)
    fft_size: int = 512
    cp_length: int = 64
    sample_rate: int = 48000
    center_freq: float = 1500.0
    modulation: Modulation = Modulation.QPSK
    tf_equalization: bool = True

    @property
    def sym_len(self) -> int:
        return self.fft_size + self.cp_length

    @property
    def preamble_len(self) -> int:
        return 4 * self.sym_len

    @property
    def frame_len(self) -> int:
        return self.preamble_len + self.N * self.sym_len

    def bits_per_frame(self, mod: Modulation | None = None) -> int:
        return self.M * self.N * bits_per_symbol(mod or self.modulation)


def isfft(dd: jnp.ndarray) -> jnp.ndarray:
    """[..., M, N] delay-Doppler -> [..., N, M] time-frequency (otfs.cpp:55-88).
    Unscaled inverse along Doppler, forward along delay."""
    temp = jnp.fft.ifft(dd, axis=-1) * dd.shape[-1]       # [..., M, N]
    return jnp.fft.fft(jnp.swapaxes(temp, -1, -2), axis=-1)  # [..., N, M]


def sfft(tf: jnp.ndarray) -> jnp.ndarray:
    """[..., N, M] -> [..., M, N] with the reference's 1/(M*N) roundtrip scale
    (otfs.cpp:91-130)."""
    N, M = tf.shape[-2], tf.shape[-1]
    temp = jnp.fft.fft(tf, axis=-2)                        # over N (time->Doppler)
    dd = jnp.fft.ifft(temp, axis=-1) * M                   # over M, unscaled
    return jnp.swapaxes(dd, -1, -2) / (M * N)


@functools.lru_cache(maxsize=None)
def sync_sequence(cfg: OTFSConfig) -> np.ndarray:
    n = np.arange(cfg.M, dtype=np.float32)
    ph = (-np.pi * n * (n + 1) / cfg.M).astype(np.float32)
    return (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _synthesis_ri(cfg: OTFSConfig, t_offset: int, S: int):
    """Sparse OFDM synthesis for the OTFS grid: only bins 1..M of the
    fft_size-point IFFT are live, so IFFT + CP + NCO upmix fold into one
    [S, M, L] tensor contraction (see ofdm/modulator._synthesis_tensors).
    Real/imag f32 pair — the device transport rejects complex constants."""
    N, cp, L = cfg.fft_size, cfg.cp_length, cfg.sym_len
    n_idx = (np.arange(L) - cp) % N
    k = np.arange(1, cfg.M + 1, dtype=np.float64)
    base = np.exp(2j * np.pi * np.outer(k, n_idx) / N) / N      # [M, L]
    osc = mixer_ops.osc_fixed(cfg.center_freq, cfg.sample_rate,
                              S * L, offset=t_offset).reshape(S, L)
    A = base[None, :, :] * osc[:, None, :]                       # [S, M, L]
    return A.real.astype(np.float32), A.imag.astype(np.float32)


def _ofdm_symbols(cfg: OTFSConfig, rows: jnp.ndarray, t_offset: int = 0) -> jnp.ndarray:
    """[..., S, M] TF rows -> [..., S*sym_len] real passband (bins 1..M, CP,
    mixer continuous from t_offset)."""
    S = rows.shape[-2]
    Ar, Ai = _synthesis_ri(cfg, t_offset, S)
    hi = jax.lax.Precision.HIGHEST
    out = jnp.einsum("...sm,sml->...sl", rows.real, jnp.asarray(Ar),
                     precision=hi) \
        - jnp.einsum("...sm,sml->...sl", rows.imag, jnp.asarray(Ai),
                     precision=hi)
    return out.reshape(*rows.shape[:-2], S * cfg.sym_len).astype(jnp.float32)


@functools.lru_cache(maxsize=None)
def generate_preamble(cfg: OTFSConfig) -> np.ndarray:
    """4x identical sync symbol, RMS-normalized to 0.1 (otfs.cpp:372-394).
    Pure host numpy: it is a constant, and eagerly shipping the complex
    sync sequence through the device transport is unsupported."""
    seq = sync_sequence(cfg)                                # np complex [M]
    Ar, Ai = _synthesis_ri(cfg, 0, 1)                        # [1, M, L]
    one = (seq.real @ Ar[0] - seq.imag @ Ai[0]).astype(np.float32)
    rms = np.sqrt((one ** 2).mean())
    if rms > 0:
        one = one * (PREAMBLE_TARGET_RMS / rms)
    return np.tile(one.astype(np.float32), 4)


def map_bits_to_dd(cfg: OTFSConfig, mod: Modulation, bits: jnp.ndarray) -> jnp.ndarray:
    """[B, nbits] -> [B, M, N] DD grid, filled k-major (otfs.cpp:307-343);
    grid cells past the data are left empty (complex zero)."""
    B, nbits = bits.shape
    bc = bits_per_symbol(mod)
    total = cfg.M * cfg.N
    pad = total * bc - nbits
    if pad < 0:
        raise ValueError("too many bits for one OTFS frame")
    b = jnp.pad(bits.astype(jnp.int32), ((0, 0), (0, pad)))
    words = (b.reshape(B, total, bc)
             * (1 << jnp.arange(bc - 1, -1, -1, dtype=jnp.int32))).sum(-1)
    tbl = jnp.asarray(con.table(mod) if mod != Modulation.BPSK
                      else np.array([-1, 1], np.complex64))
    syms = tbl[words]
    filled = jnp.arange(total) * bc < nbits
    syms = jnp.where(filled[None, :], syms, 0.0)
    return syms.reshape(B, cfg.M, cfg.N)


@functools.partial(jax.jit, static_argnames=("cfg", "mod"))
def modulate(cfg: OTFSConfig, mod: Modulation, bits: jnp.ndarray) -> jnp.ndarray:
    """[B, nbits] -> [B, N*sym_len] data samples (mixer reset at data start)."""
    dd = map_bits_to_dd(cfg, mod, bits)
    tf = isfft(dd)                                         # [B, N, M]
    return _ofdm_symbols(cfg, tf)


def frame_tx(cfg: OTFSConfig, mod: Modulation, bits: jnp.ndarray) -> jnp.ndarray:
    """Preamble + data for a batch of single-codeword frames."""
    pre = jnp.asarray(generate_preamble(cfg))
    data = modulate(cfg, mod, bits)
    B = bits.shape[0]
    return jnp.concatenate(
        [jnp.broadcast_to(pre, (B, pre.shape[0])), data], axis=-1)


def _rx_tf(cfg: OTFSConfig, samples: jnp.ndarray, t_offset: int = 0) -> jnp.ndarray:
    """[B, S*sym_len] passband -> [B, S, M] TF rows (demodulateSymbol,
    otfs.cpp:505-524): conj-mix, drop CP, FFT, bins 1..M, x2.4."""
    B = samples.shape[0]
    S = samples.shape[-1] // cfg.sym_len
    x = samples[:, :S * cfg.sym_len].reshape(B, S, cfg.sym_len)
    Mr, Mi = _analysis_ri(cfg, t_offset, S)
    hi = jax.lax.Precision.HIGHEST
    ee = functools.partial(jnp.einsum, "bsl,slm->bsm", precision=hi)
    return jax.lax.complex(ee(x, jnp.asarray(Mr)), ee(x, jnp.asarray(Mi)))


@functools.lru_cache(maxsize=None)
def _analysis_ri(cfg: OTFSConfig, t_offset: int, S: int):
    """conj(NCO) x DFT rows of bins 1..M (CP zeroed) x 2.4 scale, as a
    real/imag f32 [S, L, M] pair — the analysis dual of _synthesis_ri."""
    N, cp, L = cfg.fft_size, cfg.cp_length, cfg.sym_len
    n_idx = np.arange(L) - cp
    live = n_idx >= 0
    k = np.arange(1, cfg.M + 1, dtype=np.float64)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N, k) / N)         # [L, M]
    W = np.where(live[:, None], W, 0.0) * REAL_TO_COMPLEX_SCALE
    osc = mixer_ops.osc_fixed(cfg.center_freq, cfg.sample_rate,
                              S * L, offset=t_offset).reshape(S, L)
    M_ = np.conj(osc)[:, :, None] * W[None, :, :]                # [S, L, M]
    return M_.real.astype(np.float32), M_.imag.astype(np.float32)


def estimate_channel(cfg: OTFSConfig, preamble: jnp.ndarray) -> jnp.ndarray:
    """[B, 4*sym_len] -> [B, M] averaged LS channel estimate
    (otfs.cpp:528-588); weak bins fall back to unity."""
    rows = _rx_tf(cfg, preamble, t_offset=0)               # [B, 4, M]
    seq = jnp.asarray(sync_sequence(cfg))
    h = (rows * jnp.conj(seq)[None, None, :]).mean(-2)     # |seq|=1
    weak = jnp.abs(h) ** 2 < 0.01
    return jnp.where(weak, jnp.complex64(1.0 + 0j), h)


def _clip_llr(x):
    c = jnp.clip(x, -MAX_LLR, MAX_LLR)
    small = jnp.abs(c) < MIN_LLR_MAG
    return jnp.where(small, jnp.where(c >= 0, MIN_LLR_MAG, -MIN_LLR_MAG), c)


def _soft_demap(mod: Modulation, sym: jnp.ndarray, nv: float) -> jnp.ndarray:
    """(otfs.cpp:186-226)"""
    nv = max(0.001, nv)
    if mod == Modulation.BPSK:
        return _clip_llr(-2.0 * sym.real / nv)[..., None]
    if mod == Modulation.QAM16:
        I, Q = sym.real, sym.imag
        s = 2.0 / nv
        return _clip_llr(jnp.stack([
            -s * I, s * (jnp.abs(I) - QAM16_THRESHOLD),
            -s * Q, s * (jnp.abs(Q) - QAM16_THRESHOLD)], axis=-1))
    s = -2.0 * con.QPSK_SCALE / nv
    return _clip_llr(jnp.stack([sym.real * s, sym.imag * s], axis=-1))


@functools.partial(jax.jit, static_argnames=("cfg", "mod"))
def demodulate_frame(cfg: OTFSConfig, mod: Modulation, samples: jnp.ndarray):
    """[B, frame_len] aligned at PREAMBLE start -> LLRs [B, M*N*bc].

    OTFS_EQ: ZF TF equalization with the preamble channel estimate;
    OTFS_RAW: raw TF grid straight into the SFFT (otfs.cpp:694-708).
    DD symbols power-normalized, fixed nv=0.1 for demapping.
    """
    B = samples.shape[0]
    pre = samples[:, :cfg.preamble_len]
    data = samples[:, cfg.preamble_len:cfg.preamble_len + cfg.N * cfg.sym_len]
    tf = _rx_tf(cfg, data, t_offset=0)                     # [B, N, M]

    if cfg.tf_equalization:
        h = estimate_channel(cfg, pre)                     # [B, M]
        hp = jnp.abs(h) ** 2
        eq = jnp.where((hp > 0.01)[:, None, :],
                       tf * jnp.conj(h)[:, None, :] / jnp.maximum(hp, 1e-30)[:, None, :],
                       tf)
    else:
        eq = tf

    dd = sfft(eq)                                          # [B, M, N]
    flat = dd.reshape(B, -1)
    p = jnp.abs(flat) ** 2
    nz = p > 1e-8
    avg = jnp.where(nz, p, 0.0).sum(-1) / jnp.maximum(nz.sum(-1), 1)
    scale = jnp.where(avg > 1e-6, 1.0 / jnp.sqrt(jnp.maximum(avg, 1e-30)), 1.0)
    flat = flat * scale[:, None]

    llrs = _soft_demap(mod, flat, FIXED_DD_NOISE_VAR)
    return llrs.reshape(B, -1)


@functools.partial(jax.jit, static_argnames=("cfg", "threshold"))
def detect_frame(cfg: OTFSConfig, samples: jnp.ndarray, threshold: float = 0.7):
    """Repeated-symbol sync, batched (detectSyncReal + fineSyncPreamble,
    otfs.cpp:456-502): DETECTION gates on `threshold` (0.7 — the metric
    converges to SNR/(1+SNR), so the waveform's 10 dB floor yields ~0.91),
    while the 0.98 near-perfect rule is only FINE TIMING, with the coarse
    crossing's local peak as the reference's fallback (its fine loop
    returns 0 = keep the coarse position when 0.98 is never reached).
    Jitted: called directly by the host engine, one dispatch per search.
    Returns (found [B], start [B])."""
    from ..sync.schmidl_cox import _window_sum
    L = cfg.sym_len
    B, T = samples.shape
    prod = samples[:, :-L] * samples[:, L:]
    e2 = samples[:, L:] * samples[:, L:]
    P = _window_sum(prod, L)
    R = _window_sum(e2, L)
    metric = jnp.abs(P) / (R + 1e-10)
    metric = jnp.where(R / L > 1e-6, metric, 0.0)

    coarse = metric > threshold
    found = coarse.any(-1)
    fine = metric > 0.98
    has_fine = fine.any(-1)
    start_fine = jnp.argmax(fine, axis=-1).astype(jnp.int32)
    # Coarse fallback: the metric PLATEAUS over the 4-symbol preamble, so
    # the plateau's argmax can land up to 2 symbols late — take the FIRST
    # position within 95% of the local peak (the plateau's leading edge,
    # same bias as the reference's first->0.98 rule).
    idxb = jnp.arange(B)
    first_c = jnp.argmax(coarse, axis=-1).astype(jnp.int32)
    rel = jnp.arange(2 * L)
    widx = jnp.clip(first_c[:, None] + rel[None, :], 0, metric.shape[-1] - 1)
    wmet = metric[idxb[:, None], widx]
    pv = wmet.max(-1, keepdims=True)
    lead = jnp.argmax(wmet >= 0.95 * pv, axis=-1)
    start_coarse = widx[idxb, lead]
    start = jnp.where(has_fine, start_fine, start_coarse).astype(jnp.int32)
    return found, start
