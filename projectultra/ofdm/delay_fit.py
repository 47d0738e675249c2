"""Delay-domain channel-model retry for coherent pilot plans (beyond-reference).

The pilot-tracked estimator interpolates the channel LINEARLY between pilot
carriers (demodulator._interpolate_channel — reference parity,
demodulator.cpp:137-193).  Under a frequency-selective fade that model is the
binding error: an ITU-R Watterson channel is 2-3 DISCRETE paths, so the true
transfer function is H(f) = sum_k a_k * exp(-2j*pi*f*tau_k) — a notch's shape
between two pilots is NOT linear, and the mis-fit both mis-equalizes and
mis-weights the carriers near the notch walls.  Measured on the Good-channel
high_throughput row (QAM16 R2/3, 20 dB, 8 codewords): pre-decode BER is
5-13% against a ~5-7% decode threshold, and a genie per-carrier estimate
recovers 80% of codewords vs 58% for the production pipeline — the gap is
frequency-interpolation error, not noise (docs/PERF.md round 5).

This module fits the physical model directly:

1. Per-symbol pilot LS estimates, common-phase-derotated and time-smoothed
   (W=5 symbols; the common phase must come out first or smoothing across a
   residual-CFO rotation biases the estimate — measured).
2. Matching pursuit on the frame-averaged pilot response over a dense delay
   grid (+-60..120 samples, 1-sample steps): pick the K=3 dominant path
   delays, re-fitting jointly after each pick (taus land on the true
   two-path structure, e.g. {0, +-24} for the 0.5 ms Good preset).
3. Ridge LS projection of every symbol's smoothed pilot estimate onto the
   K-tap subspace -> model-exact notch shapes at ALL carriers + ~Np/K
   noise averaging.
4. MMSE equalize + demap with the production fade-erasure/clipping rules.

Wired as a FAILED-DECODE RETRY only (modem/acquisition/cox.py, after the
front and SRO retries): zero behavior change for healthy frames, so every
bit-exactness/golden anchor is untouched.  Measured on the Good20 row:
codeword decode 66% -> 82% (4 channel seeds x 8 realizations x 8 codewords,
tools/test_throughput.py).  No reference counterpart (the reference has only
the linear interpolator; its own Good-channel decode on this row measures 0%
— docs/PARITY.md "Good-channel high-throughput row").

Device notes: the whole second pass is one jit — the delay-grid search is a
[Np, G] matmul, the per-symbol projections are einsums, and the 1x1/2x2/3x3
Hermitian solves are explicit Cramer forms (no LAPACK on device).  The grid
constants are separate real/imag f32 arrays.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ModemConfig, Modulation, bits_per_symbol
from . import carriers as carriers_mod
from . import demodulator as demod_mod
from ..ops import demap as demap_ops

TAU_GRID = np.arange(-60.0, 121.0, 1.0)   # delay grid, samples at fs
K_TAPS = 3                                # matching-pursuit model order
RIDGE = 0.1                               # absolute ridge (Gram diag = Np)
SMOOTH_W = 5                              # pilot time-smoothing window
TAU_EXCLUDE = 2                           # min tau separation, samples


@functools.lru_cache(maxsize=None)
def _host_tables(config: ModemConfig):
    """Static per-config tables, complex split into f32 pairs."""
    cm = carriers_mod.carrier_map(config)
    kp = np.asarray(cm.pilot_k, np.float64)
    N = config.fft_size
    FG = np.exp(-2j * np.pi * kp[:, None] * TAU_GRID[None, :] / N)  # [Np, G]
    return (FG.real.astype(np.float32), FG.imag.astype(np.float32),
            kp.astype(np.float32),
            np.asarray(cm.data_k, np.float32))


@functools.lru_cache(maxsize=None)
def _smooth_matrix(S: int) -> np.ndarray:
    """[S, S] moving-average operator with exact edge normalization."""
    sm = np.zeros((S, S), np.float32)
    half = SMOOTH_W // 2
    for s in range(S):
        lo, hi = max(0, s - half), min(S, s + half + 1)
        sm[s, lo:hi] = 1.0 / (hi - lo)
    return sm


def _solve_herm(A, b):
    """Solve A x = b for Hermitian positive-definite A of static size 1-3.

    A: [B, k, k] complex, b: [B, k, M] complex -> [B, k, M].  Explicit
    Cramer/adjugate forms — jnp.linalg.solve is not trusted on the
    accelerator backend for small batched complex systems.
    """
    k = A.shape[-1]
    if k == 1:
        return b / A[:, 0:1, 0:1]
    if k == 2:
        a, bb = A[:, 0, 0], A[:, 0, 1]
        c, d = A[:, 1, 0], A[:, 1, 1]
        det = (a * d - bb * c)[:, None]
        x0 = (d[:, None] * b[:, 0] - bb[:, None] * b[:, 1]) / det
        x1 = (-c[:, None] * b[:, 0] + a[:, None] * b[:, 1]) / det
        return jnp.stack([x0, x1], axis=1)
    # k == 3: adjugate
    a00, a01, a02 = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    a10, a11, a12 = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    a20, a21, a22 = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = (a00 * c00 + a01 * c10 + a02 * c20)[:, None]
    x0 = (c00[:, None] * b[:, 0] + c01[:, None] * b[:, 1]
          + c02[:, None] * b[:, 2]) / det
    x1 = (c10[:, None] * b[:, 0] + c11[:, None] * b[:, 1]
          + c12[:, None] * b[:, 2]) / det
    x2 = (c20[:, None] * b[:, 0] + c21[:, None] * b[:, 1]
          + c22[:, None] * b[:, 2]) / det
    return jnp.stack([x0, x1, x2], axis=1)


@functools.partial(jax.jit, static_argnames=("config", "mod", "n_bits"))
def demod_delayfit(config: ModemConfig, mod: Modulation, fd: jnp.ndarray,
                   n_bits: int) -> jnp.ndarray:
    """Second-pass demod from raw FD bins: [B, S, Cu] -> LLRs [B, n_bits]."""
    cm = carriers_mod.carrier_map(config)
    Cd, Np = len(cm.data_idx), len(cm.pilot_idx)
    B, S, _ = fd.shape
    N = config.fft_size
    FGr, FGi, kp, kd = _host_tables(config)
    FGr, FGi = jnp.asarray(FGr), jnp.asarray(FGi)
    kp, kd = jnp.asarray(kp), jnp.asarray(kd)
    pilot_seq = jnp.asarray(cm.pilot_seq)           # 1-D complex: transport-safe

    h_ls = fd[:, :, Cd:] / pilot_seq[None, None, :]            # [B, S, Np]

    # Common-phase derotation vs symbol 0 (residual CFO/phase noise would
    # bias a time average of complex estimates).
    rot_raw = (h_ls * jnp.conj(h_ls[:, :1])).sum(-1)           # [B, S]
    rot = rot_raw / jnp.maximum(jnp.abs(rot_raw), 1e-30)
    hd = h_ls * jnp.conj(rot)[..., None]                       # derotated

    SM = jnp.asarray(_smooth_matrix(S))
    Hp = jnp.einsum("st,btp->bsp", SM, hd)                     # smoothed [B,S,Np]
    hbar = hd.mean(1)                                          # [B, Np]

    # --- matching pursuit over the delay grid (K_TAPS unrolled picks) ----
    FG = jax.lax.complex(FGr, FGi)                             # [Np, G]
    G = FG.shape[1]
    grid = jnp.asarray(TAU_GRID.astype(np.float32))
    r = hbar
    taus = []
    banned = jnp.zeros((B, G), bool)
    for _k in range(K_TAPS):
        c = jnp.einsum("bp,pg->bg", r, jnp.conj(FG)) / Np      # [B, G]
        score = jnp.where(banned, -1.0, jnp.abs(c))
        idx = jnp.argmax(score, axis=-1)                       # [B]
        taus.append(grid[idx])
        banned = banned | (jnp.abs(grid[None, :] - grid[idx][:, None])
                           <= TAU_EXCLUDE)
        t = jnp.stack(taus, axis=-1)                           # [B, k]
        ph = (-2.0 * np.pi / N) * kp[None, :, None] * t[:, None, :]
        F = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))          # [B, Np, k]
        A = (jnp.einsum("bpj,bpk->bjk", jnp.conj(F), F)
             + RIDGE * jnp.eye(len(taus), dtype=jnp.complex64)[None])
        rhs = jnp.einsum("bpk,bp->bk", jnp.conj(F), hbar)[..., None]
        a = _solve_herm(A, rhs)[..., 0]                        # [B, k]
        r = hbar - jnp.einsum("bpk,bk->bp", F, a)

    # --- per-symbol ridge projection onto the fitted tap subspace --------
    Ainv_rhs = jnp.einsum("bpk,bsp->bsk", jnp.conj(F), Hp)     # [B, S, K]
    a_s = _solve_herm(A, jnp.moveaxis(Ainv_rhs, 1, 2))         # [B, K, S]
    phd = (-2.0 * np.pi / N) * kd[None, :, None] * t[:, None, :]
    Fd = jax.lax.complex(jnp.cos(phd), jnp.sin(phd))           # [B, Cd, K]
    Hd_m = jnp.einsum("bdk,bks->bsd", Fd, a_s)                 # [B, S, Cd]
    Hp_m = jnp.einsum("bpk,bks->bsp", F, a_s)                  # [B, S, Np]

    # Noise per symbol from the model residual at the pilots.
    nv_t = jnp.maximum((jnp.abs(hd - Hp_m) ** 2).mean(-1), 1e-6)  # [B, S]

    # Re-rotate the model and MMSE-equalize (production constants:
    # demodulator.equalize's clipping + fade-erasure rules).
    Hd_m = Hd_m * rot[..., None]
    hp = jnp.abs(Hd_m) ** 2
    nv = nv_t[..., None]
    denom = hp + nv
    eq = jnp.conj(Hd_m) * fd[:, :, :Cd] / jnp.maximum(denom, 1e-30)
    cnv = jnp.clip(nv / (hp + 1e-6), demod_mod.MIN_CARRIER_NOISE_VAR,
                   demod_mod.MAX_CARRIER_NOISE_VAR)
    avg_hp = hp.mean(-1, keepdims=True)
    cnv = jnp.where(hp < demod_mod.FADE_THRESHOLD_RATIO * avg_hp,
                    demod_mod.MAX_CARRIER_NOISE_VAR, cnv)
    cnv = cnv * demap_ops.CE_MARGIN.get(mod, 1.0)
    llrs = demap_ops.demap(mod, eq.reshape(B, -1), cnv.reshape(B, -1))
    return llrs.reshape(B, -1)[:, :n_bits]


@functools.partial(jax.jit, static_argnames=("config", "mod", "n_lts", "S",
                                             "lead", "tail", "front"))
def span_fd(config: ModemConfig, mod: Modulation, span: jnp.ndarray,
            cfo_hz, initial_phase, n_lts: int, S: int,
            lead: int = 0, tail: int = 0,
            front: str = "analytic") -> jnp.ndarray:
    """Raw per-symbol FD bins for a Cox span: [B, T] real -> [B, S, Cu].

    Mirrors demodulate_span's conversion/slicing/mixer bookkeeping
    (sync/schmidl_cox.decode_ofdm_cox margins), with the per-symbol pilot
    tracking ON so the CFO/timing corrections baked into fd match what the
    first pass saw.  Kept as one jit."""
    if front == "real":
        span = span.astype(jnp.complex64)
    else:
        span = demod_mod.maybe_analytic(
            mod, demod_mod._edge_tapered(mod, span, lead, tail))
    plen = config.fft_size + config.cyclic_prefix
    B = span.shape[0]
    lts = span[:, lead:lead + n_lts * plen].reshape(B, n_lts, plen)
    d0 = n_lts * plen
    L = config.symbol_duration
    data = span[:, lead + d0:lead + d0 + S * L].reshape(B, S, L)

    state = demod_mod.init_state(config, B, cfo_hz, initial_phase)
    state = demod_mod.estimate_channel_from_lts(
        config, state, lts, t0_base=plen, t0_stride=0,
        image_cancel=False, taper=False)
    has_pilots = len(carriers_mod.carrier_map(config).pilot_idx) > 0

    def step(carry, xs):
        st = carry
        sym, s_idx = xs
        fd, st = demod_mod.to_baseband_fd(config, st, sym, d0 + s_idx * L)
        if has_pilots:
            st = demod_mod.update_channel_estimate(config, st, fd)
        return st, fd

    xs = (jnp.moveaxis(data, 1, 0), jnp.arange(S))
    _, fds = jax.lax.scan(step, state, xs)
    return jnp.moveaxis(fds, 0, 1)


def demodulate_span_delayfit(config: ModemConfig, mod: Modulation,
                             span: jnp.ndarray, cfo_hz, initial_phase,
                             n_lts: int, S: int, lead: int = 0,
                             tail: int = 0, front: str = "analytic",
                             n_bits: int | None = None) -> jnp.ndarray:
    """Full delay-model second pass over a span -> LLRs [B, n_bits]."""
    if n_bits is None:
        cm = carriers_mod.carrier_map(config)
        n_bits = S * len(cm.data_idx) * bits_per_symbol(mod)
    fd = span_fd(config, mod, span, cfo_hz, initial_phase, n_lts, S,
                 lead=lead, tail=tail, front=front)
    return demod_delayfit(config, mod, fd, n_bits)
