"""Batched OFDM demodulator: passband audio -> soft LLRs, on device.

Batched JAX rework of src/ofdm/{demodulator.cpp, channel_equalizer.cpp,
soft_demap.hpp}.  The streaming C++ state machine becomes a ``lax.scan``
over the symbol axis whose carry is exactly the reference's Impl state
(demodulator_impl.hpp:20-119): channel estimate, CFO tracker, pilot phases,
differential references, noise/SNR trackers.  The batch axis [B] rides
every array, so thousands of independent frames demodulate in one program.

This module implements the *presynced* path (processPresynced,
demodulator.cpp:854-985): samples are already aligned to the training start
(by chirp sync or by the test harness); CFO comes in as data.  The streaming
Schmidl-Cox SEARCHING/SYNCED machine builds on these same per-symbol kernels
in sync/schmidl_cox.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModemConfig, Modulation, bits_per_symbol, is_differential
from ..ops import demap as demap_ops
from ..ops import mixer as mixer_ops
from . import carriers as carriers_mod

# Constants from demodulator_constants.hpp / demodulator_impl.hpp.
DEFAULT_NOISE_VAR = 0.1
DEFAULT_SNR_LINEAR_FALLBACK = 31.6   # first-symbol 15 dB assumption
SNR_ALPHA = 0.3
FREQ_OFFSET_ALPHA = 0.3
CFO_ACQUISITION_SYMBOLS = 10
MAX_CFO_HZ = 90.0
TIMING_ALPHA = 0.3
PHASE_INTERP_THRESHOLD = 1.5708      # pi/2
FADE_THRESHOLD_RATIO = 0.1
MIN_CARRIER_NOISE_VAR = 1e-6
MAX_CARRIER_NOISE_VAR = 100.0
LDPC_BLOCK_SIZE = 648

# 256QAM RX flavor: "analytic" (Hilbert front-end + folded-Tukey window,
# no conjugate image by construction) or "real" (real passband + Tukey +
# closed-form image cancellation).  See maybe_analytic for the physics.
QAM256_RX = "analytic"


def _hi_order(mod: Modulation) -> bool:
    """Modulations dense enough that the symbol-boundary Hilbert ringing
    floor (~-25 dB EVM with a rect analysis window, see maybe_analytic)
    binds: they get the folded-Tukey window + DD refinement ladder.
    <=32QAM keeps the rect window for reference golden parity (its
    decision distances never feel the floor)."""
    return mod in (Modulation.QAM64, Modulation.QAM256)


class DemodState(NamedTuple):
    """Scan carry == OFDMDemodulator::Impl tracked state, batched on [B]."""
    freq_offset_hz: jnp.ndarray          # [B] f32
    freq_offset_filtered: jnp.ndarray    # [B] f32
    freq_phase: jnp.ndarray              # [B] f32 CFO-correction phase accum
    channel_estimate: jnp.ndarray        # [B, N] c64
    dbpsk_prev: jnp.ndarray              # [B, C] c64
    pilot_phase_correction: jnp.ndarray  # [B] c64
    prev_pilot_phases: jnp.ndarray       # [B, Np] c64
    have_prev_pilots: jnp.ndarray        # [B] bool
    carrier_phase_correction: jnp.ndarray  # [B] c64
    carrier_phase_initialized: jnp.ndarray  # [B] bool
    noise_variance: jnp.ndarray          # [B] f32
    estimated_snr_linear: jnp.ndarray    # [B] f32
    snr_symbol_count: jnp.ndarray        # [B] i32
    symbols_since_sync: jnp.ndarray      # [B] i32
    timing_offset_samples: jnp.ndarray   # [B] f32
    eq_weights: jnp.ndarray              # [B, C] c64 LMS/RLS adaptive weights
    rls_P: jnp.ndarray                   # [B, C] f32 RLS inverse-corr scalars


def init_state(config: ModemConfig, B: int, cfo_hz, initial_phase) -> DemodState:
    """processPresynced reset (demodulator.cpp:869-905): unity channel,
    nv=0.1, CFO/phase preserved from external (chirp) estimation."""
    cm = carriers_mod.carrier_map(config)
    N, C, Np = config.fft_size, len(cm.data_idx), max(len(cm.pilot_idx), 1)
    cfo = jnp.broadcast_to(jnp.asarray(cfo_hz, jnp.float32), (B,))
    phase = jnp.broadcast_to(jnp.asarray(initial_phase, jnp.float32), (B,))
    ones_c = jnp.ones((B,), jnp.complex64)
    return DemodState(
        freq_offset_hz=cfo,
        freq_offset_filtered=cfo,
        freq_phase=phase,
        channel_estimate=jnp.ones((B, N), jnp.complex64),
        dbpsk_prev=jnp.ones((B, C), jnp.complex64),
        pilot_phase_correction=ones_c,
        prev_pilot_phases=jnp.zeros((B, Np), jnp.complex64),
        have_prev_pilots=jnp.zeros((B,), bool),
        carrier_phase_correction=ones_c,
        carrier_phase_initialized=jnp.zeros((B,), bool),
        noise_variance=jnp.full((B,), DEFAULT_NOISE_VAR, jnp.float32),
        estimated_snr_linear=jnp.ones((B,), jnp.float32),
        snr_symbol_count=jnp.zeros((B,), jnp.int32),
        symbols_since_sync=jnp.zeros((B,), jnp.int32),
        timing_offset_samples=jnp.zeros((B,), jnp.float32),
        eq_weights=jnp.ones((B, C), jnp.complex64),
        rls_P=jnp.ones((B, C), jnp.float32),
    )


# ---------------------------------------------------------------------------
# Per-symbol kernels
# ---------------------------------------------------------------------------

def _fold_ramp(config: ModemConfig, L: int) -> int:
    """Ramp length of the folded-Tukey analysis window: the usable cyclic
    slack, bounded by the CP."""
    return max(0, min(config.cyclic_prefix, L - config.fft_size))


@functools.lru_cache(maxsize=None)
def _used_bins_w(config: ModemConfig, L: int, window: str = "rect"):
    """DFT rows of the USED bins ([data..., pilot...]) with the CP/guard
    region zeroed, as real/imag f32 [L, Cu] pairs (the device transport
    rejects multi-dim complex64 host constants).

    window="tukey" replaces the rectangular [cp, cp+N) window with a
    folded Tukey window over [0, N+R) (ramps of length R = min(cp, L-N),
    w[n] + w[n+N] = 1 on the overlap).  For content that is cyclic after
    the CFO-corrected demix — true whenever fc*N/fs is an integer, which
    holds for every config (1500 Hz, 48 kHz, N >= 32) — the folded window
    computes EXACTLY the same bin values as the rectangular one.  What
    changes is the weighting of symbol-boundary samples: a true (SSB)
    frequency offset Hilbert-rings at the rect-window edge that abuts the
    symbol boundary (~1/(pi*d) from the FIRST sample, a payload-dependent
    -25 dB ICI floor), and the Tukey taper de-weights exactly those
    samples (~-50 dB).  Used by the 256QAM real-passband path together
    with the matching windowed image kernel in cancel_conjugate_image."""
    cm = carriers_mod.carrier_map(config)
    N, cp = config.fft_size, config.cyclic_prefix
    bins = np.concatenate([np.asarray(cm.data_idx),
                           np.asarray(cm.pilot_idx)]).astype(np.float64)
    n = np.arange(L)
    if window == "tukey":
        R = _fold_ramp(config, L)
        w = np.zeros(L)
        if R > 0:
            up = np.sin(np.pi * (np.arange(R) + 0.5) / (2 * R)) ** 2
            w[:R] = up
            w[R:N] = 1.0
            w[N:N + R] = 1.0 - up
        else:
            w[:N] = 1.0
        W = w[:, None] * np.exp(-2j * np.pi
                                * np.outer((n - cp) % N, bins) / N)
    else:
        n_idx = n - cp
        live = (n_idx >= 0) & (n_idx < N)
        W = np.exp(-2j * np.pi * np.outer(n_idx % N, bins) / N)
        W = np.where(live[:, None], W, 0.0)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def n_data_bins(config: ModemConfig) -> int:
    return len(carriers_mod.carrier_map(config).data_idx)


@functools.lru_cache(maxsize=None)
def _pilot_to_data_interp(config: ModemConfig) -> np.ndarray:
    """[Cd, Np] row-stochastic linear-interpolation weights mapping
    per-PILOT noise measurements onto the data carriers by signed bin
    number (nearest-pilot clamp at the band edges).  Used by the
    high-order per-carrier noise pass in _scan_data_symbols."""
    cm = carriers_mod.carrier_map(config)
    dk = np.asarray(cm.data_k, np.float64)
    pk = np.asarray(cm.pilot_k, np.float64)
    order = np.argsort(pk)
    pks = pk[order]
    W = np.zeros((len(dk), len(pk)), np.float32)
    for i, k in enumerate(dk):
        j = np.searchsorted(pks, k)
        if j == 0:
            W[i, order[0]] = 1.0
        elif j >= len(pks):
            W[i, order[-1]] = 1.0
        else:
            lo, up = pks[j - 1], pks[j]
            a = (k - lo) / (up - lo) if up > lo else 0.5
            W[i, order[j - 1]] = 1.0 - a
            W[i, order[j]] = a
    return W


@jax.jit
def analytic_half(samples: jnp.ndarray) -> jnp.ndarray:
    """Positive-frequency part of a real passband signal (analytic/2):
    same amplitude as the real signal's +f content, image-free.  No-op for
    already-complex input.  Jitted: host callers (the modem engine) would
    otherwise run eager complex FFTs, unimplemented on the accelerator."""
    if jnp.iscomplexobj(samples):
        return samples
    from ..sync.schmidl_cox import analytic_signal
    return (0.5 * analytic_signal(samples)).astype(jnp.complex64)


def maybe_analytic(mod: Modulation, samples: jnp.ndarray,
                   front: str = "analytic") -> jnp.ndarray:
    """analytic_half for COHERENT modulations.  The real passband's
    negative-frequency image is bin-aligned (harmless) at zero CFO but
    leaks ICI that grows with CFO; QAM decision boundaries cannot absorb
    it, while the differential modes tolerate it across the validated CFO
    range — and skipping the Hilbert FFT there keeps the headline
    pipeline FFT-free.

    256QAM sits at a -32 dB-ish EVM budget where BOTH front-ends have a
    measurable floor, and which one binds is subtle (all measured, see
    docs/PERF.md '256QAM ICI ladder'):

    * analytic + rect window: the within-window tone model differs from
      the global Hilbert's output by symbol-boundary ringing (~1/(pi*d)
      from a window edge that abuts the boundary) — a payload-dependent,
      CFO-INDEPENDENT ~-25 dB ICI floor, saturated 12% codeword failures
      identical at 42 and 90 dB.
    * real passband: exact at zero CFO (no Hilbert anywhere, the image is
      bin-orthogonal), but a true (SSB) frequency offset couples the
      boundary ringing in — fatal beyond ~0.5 Hz uncancelled, and still
      ~-21 dB on the lowest carrier after closed-form image cancellation
      (cancel_conjugate_image) + Tukey taper.
    * analytic + folded-Tukey window (CHOSEN, QAM256_RX="analytic"): a
      true frequency shift of a real passband preserves one-sidedness, so
      the RX Hilbert recovers the TX analytic signal essentially exactly
      under CFO; the taper then de-weights the boundary samples where the
      TX-side ringing lives.  No image by construction, no K matrices.

    Combined with the decision-directed refinement pass
    (_demod_coherent_refined) this holds 256QAM R5/6 at 100% codewords
    across +-10 Hz CFO at 42 dB on 32-codeword NVIS frames."""
    if front == "real" or is_differential(mod) or (
            mod == Modulation.QAM256 and QAM256_RX == "real"):
        return samples
    return analytic_half(samples)


@functools.lru_cache(maxsize=None)
def _used_bins_k(config: ModemConfig) -> np.ndarray:
    """Signed bin numbers of the USED bins in to_baseband_fd's
    [data..., pilot...] layout."""
    cm = carriers_mod.carrier_map(config)
    return np.concatenate([np.asarray(cm.data_k),
                           np.asarray(cm.pilot_k)]).astype(np.float32)


def _dirichlet(x, R: int, N: int):
    """D_R(x) = sum_{n=0}^{R-1} e^{-j*2pi*n*x/N}, safe at x = 0 (-> R)."""
    mag = R * jnp.sinc(R * x / N) / jnp.sinc(x / N)
    ang = -(np.pi * (R - 1) / N) * x
    return jax.lax.complex(mag * jnp.cos(ang), mag * jnp.sin(ang))


def cancel_conjugate_image(config: ModemConfig, state: DemodState,
                           fd: jnp.ndarray, t0, L: int) -> jnp.ndarray:
    """Frequency-domain cancellation of a REAL passband's conjugate image.

    A real passband window is x[n] = Re{sum_m u_m e^{j2pi(fc+f_m+d)(t0+n)/fs}}
    (d = true CFO); after the demixer (conj(osc) * CFO correction) the
    conjugate half lands at -(2fc + f_m + d + d_hat)/df bins — integer
    (bin-orthogonal, zero leak) at d = 0, but misaligned by ~2d/df under
    CFO, leaking ICI into every used bin k with a closed-form windowed
    Dirichlet weight.  Writing the leak as fd = fd_clean + K conj(fd_clean),
    for the folded-Tukey analysis window of _used_bins_w (ramp R):

        K[b,k,m]  = e^{j*Gamma_b} / N * e^{j*2pi*cp*(k_k+k_m)/N}
                     * E_w(nu[b,m] + k_k)
        nu[b,m]   = (2fc + 2*d_hat_b) * N/fs + k_m
        Gamma_b   = 2*freq_phase_b - 2*phi0(t0)
        E_w(x)    = E_N(x) - (1 - e^{-j*2pi*x}) * G(x)
        G(x)      = D_R(x)/2 + [e^{j*pi/(2R)} D_R(x - N/(2R))
                                + e^{-j*pi/(2R)} D_R(x + N/(2R))] / 4
        D_R(x)    = sum_{n<R} e^{-j*2pi*n*x/N}   (Dirichlet)

    with phi0(t0) = 2pi*fc*t0/fs computed integer-modular (exact, like
    ops/mixer.osc_int) and k the signed used-bin numbers.  Inverting to
    second order (||K|| ~ 0.05 at 10 Hz): w = fd - K conj(fd), then
    fd_clean ~= w + K conj(K) w.  Combined with the Tukey taper's
    suppression of symbol-boundary Hilbert ringing (see _used_bins_w)
    the residual image sits < -50 dB across the +-10 Hz acquisition
    envelope, vs -18 dB uncancelled at 10 Hz.  All terms are
    [B,Cu,Cu]x[B,Cu] matmuls; K -> 0 smoothly as the tracked CFO -> 0.
    Used by the 256QAM real-passband path (see maybe_analytic); <=32QAM
    decision distances never needed it."""
    N, cp = config.fft_size, config.cyclic_prefix
    fs, fc = config.sample_rate, config.center_freq
    R = _fold_ramp(config, L)
    k = jnp.asarray(_used_bins_k(config))                       # [Cu]

    active = jnp.abs(state.freq_offset_hz) > 0.01
    d_hat = jnp.where(active, state.freq_offset_hz, 0.0)        # [B]
    fp = jnp.where(active, state.freq_phase, 0.0)               # [B]

    # Exact 2*pi*fc*t0/fs mod 2*pi via integer-modular arithmetic.
    t0i = jnp.asarray(t0, jnp.int32)
    num = jnp.mod(fc * jnp.mod(t0i, fs), fs)
    phi0 = (2.0 * np.pi / fs) * num.astype(jnp.float32)

    nu = (2.0 * fc + 2.0 * d_hat[:, None]) * (N / fs) + k[None, :]   # [B,Cu]
    x = nu[:, None, :] + k[None, :, None]                       # [B, k, m]
    gamma = 2.0 * fp - 2.0 * phi0                               # [B]

    EN = _dirichlet(x, N, N)
    if R > 0:
        half = N / (2.0 * R)
        rot = np.exp(1j * np.pi / (2.0 * R)).astype(np.complex64)
        G = (0.5 * _dirichlet(x, R, N)
             + 0.25 * (rot * _dirichlet(x - half, R, N)
                       + np.conj(rot) * _dirichlet(x + half, R, N)))
        tx2pi = 2.0 * np.pi * x
        one_m = 1.0 - jax.lax.complex(jnp.cos(tx2pi), -jnp.sin(tx2pi))
        Ew = EN - one_m * G
    else:
        Ew = EN

    ang = (gamma[:, None, None]
           + (2.0 * np.pi * cp / N) * (k[None, :, None] + k[None, None, :]))
    K = (1.0 / N) * jax.lax.complex(jnp.cos(ang), jnp.sin(ang)) * Ew

    hi = jax.lax.Precision.HIGHEST
    mv = functools.partial(jnp.einsum, "bkm,bm->bk", precision=hi)
    w = fd - mv(K, jnp.conj(fd))
    clean = w + mv(K, jnp.conj(mv(K, jnp.conj(w))))
    return clean.astype(jnp.complex64)


def to_baseband_fd(config: ModemConfig, state: DemodState,
                   sym_samples: jnp.ndarray, t0,
                   image_cancel: bool = False,
                   taper: bool = False) -> tuple[jnp.ndarray, DemodState]:
    """toBaseband + extractSymbol (channel_equalizer.cpp:19-71) for one
    symbol: [B, L] passband -> [B, Cu] USED frequency bins, laid out
    [data..., pilot...].  Only those bins are ever consumed, so downmix +
    bin extraction run as one small contraction instead of a full FFT.
    ``t0`` is the sample index
    of this window since the last mixer reset.  Advances the CFO correction
    phase by L samples (only when |cfo| > 0.01, like the C++)."""
    L = sym_samples.shape[-1]
    t = t0 + jnp.arange(L)
    osc = mixer_ops.osc_int(config.center_freq, config.sample_rate, t)  # [L]

    phase_inc = jnp.float32(-2.0 * np.pi / config.sample_rate) * state.freq_offset_hz
    i = jnp.arange(L, dtype=jnp.float32)
    corr_phase = state.freq_phase[:, None] + phase_inc[:, None] * i
    corr = jnp.exp(1j * corr_phase).astype(jnp.complex64)
    active = (jnp.abs(state.freq_offset_hz) > 0.01)[:, None]
    corr = jnp.where(active, corr, jnp.complex64(1.0))

    z = sym_samples.astype(jnp.complex64) * jnp.conj(osc)[None, :] * corr
    Wr, Wi = _used_bins_w(config, int(L),
                          "tukey" if (image_cancel or taper) else "rect")
    Wr, Wi = jnp.asarray(Wr), jnp.asarray(Wi)
    hi = jax.lax.Precision.HIGHEST
    mm = functools.partial(jnp.matmul, precision=hi)
    fd = jax.lax.complex(mm(z.real, Wr) - mm(z.imag, Wi),
                         mm(z.real, Wi) + mm(z.imag, Wr))
    if image_cancel:
        fd = cancel_conjugate_image(config, state, fd, t0, int(L))

    new_phase = jnp.where(
        active[:, 0],
        jnp.mod(state.freq_phase + phase_inc * L + np.pi, 2 * np.pi) - np.pi,
        state.freq_phase)
    return fd, state._replace(freq_phase=new_phase)


def update_channel_estimate(config: ModemConfig, state: DemodState,
                            fd: jnp.ndarray) -> DemodState:
    """Pilot-based per-symbol tracking (channel_equalizer.cpp:330-595):
    LS pilot estimates, carrier-phase recovery, EMA channel smoothing,
    temporal noise estimation, residual-CFO and timing-slope tracking,
    pilot interpolation."""
    cm = carriers_mod.carrier_map(config)
    if len(cm.pilot_idx) == 0:
        return state
    pilot_idx = jnp.asarray(cm.pilot_idx)
    pilot_seq = jnp.asarray(cm.pilot_seq)
    Np = len(cm.pilot_idx)

    alpha = jnp.where(state.snr_symbol_count == 0, 1.0, 0.9)[:, None]

    # fd is the compact used-bins layout [data..., pilot...].
    h_ls = fd[:, len(cm.data_idx):] / pilot_seq[None, :]          # [B, Np]

    # DELIBERATE DEVIATION from channel_equalizer.cpp:348-363: the
    # reference's "carrier phase recovery" strips the first symbol's average
    # pilot phase out of H — which REINJECTS that constant phase into every
    # equalized symbol (eq = conj(H*cpc)*rx keeps e^{j*avg_phase}).  That is
    # harmless at the reference's validated operating points (true CFO ~ 0,
    # sample-exact LTS timing) but rotates the whole constellation past a
    # decision boundary once timing + CFO offsets stack up.  Plain conj(H)
    # equalization cancels constant phases exactly, so we keep cpc == 1.
    cpc = state.carrier_phase_correction
    initialized = state.carrier_phase_initialized

    signal_power = (jnp.abs(h_ls) ** 2).mean(-1)

    # Temporal noise estimate vs previous pilots.
    prev = state.prev_pilot_phases
    valid = ((jnp.abs(prev) ** 2 > 1e-6) & (jnp.abs(h_ls) ** 2 > 1e-6)
             & state.have_prev_pilots[:, None])
    diff2 = jnp.where(valid, jnp.abs(h_ls - prev) ** 2, 0.0)
    noise_sum = diff2.sum(-1)
    noise_count = valid.sum(-1)
    noise_sum = jnp.where(noise_count == 0,
                          signal_power / DEFAULT_SNR_LINEAR_FALLBACK, noise_sum)
    noise_count = jnp.maximum(noise_count, 1)

    # Smoothed channel estimate at pilots.
    ce = state.channel_estimate
    old = ce[:, pilot_idx]
    ce = ce.at[:, pilot_idx].set(alpha * h_ls + (1.0 - alpha) * old)

    # Residual CFO from pilot phase rotation.
    d = h_ls * jnp.conj(prev)
    dmag = jnp.abs(d)
    unit_ok = (jnp.abs(prev) ** 2 > 1e-6) & (jnp.abs(h_ls) ** 2 > 1e-6) & (dmag > 1e-6)
    unit_ok = unit_ok & state.have_prev_pilots[:, None]
    unit = jnp.where(unit_ok, d / jnp.maximum(dmag, 1e-30), 0.0)
    vcount = unit_ok.sum(-1)
    have_cfo = vcount > 0
    avg_diff = unit.sum(-1) / jnp.maximum(vcount, 1)
    avg_phase = jnp.arctan2(avg_diff.imag, avg_diff.real)

    ppc = jnp.where(have_cfo, jnp.exp(-1j * avg_phase).astype(jnp.complex64),
                    jnp.complex64(1.0))
    # (reference resets pilot_phase_correction to (1,0) when no prev pilots)

    sym_dur = config.symbol_duration / config.sample_rate
    residual = avg_phase / (2 * np.pi * sym_dur)
    total_cfo = state.freq_offset_hz + residual
    progress = jnp.clip(state.symbols_since_sync / CFO_ACQUISITION_SYMBOLS, 0, 1)
    ad_alpha = 0.9 * (1 - progress) + FREQ_OFFSET_ALPHA * progress
    ad_alpha = jnp.where(jnp.abs(residual) > 10.0,
                         jnp.maximum(ad_alpha, 0.9), ad_alpha)
    fof = jnp.where(have_cfo,
                    ad_alpha * total_cfo + (1 - ad_alpha) * state.freq_offset_filtered,
                    state.freq_offset_filtered)
    foh = jnp.where(have_cfo, jnp.clip(fof, -MAX_CFO_HZ, MAX_CFO_HZ),
                    state.freq_offset_hz)
    ssc = state.symbols_since_sync + jnp.where(have_cfo, 1, 0)

    # Timing recovery: LS fit of pilot phase slope vs signed bin index.
    tmask = jnp.abs(h_ls) ** 2 >= 1e-6
    k = jnp.asarray(cm.pilot_k, jnp.float32)[None, :]
    ph = jnp.angle(h_ls)
    nvalid = tmask.sum(-1)
    sum_k = (k * tmask).sum(-1)
    sum_k2 = (k * k * tmask).sum(-1)
    sum_p = (ph * tmask).sum(-1)
    sum_kp = (k * ph * tmask).sum(-1)
    denom = nvalid * sum_k2 - sum_k * sum_k
    can_fit = (state.snr_symbol_count >= 3) & (nvalid >= 3) & (jnp.abs(denom) > 1e-6)
    slope = (nvalid * sum_kp - sum_k * sum_p) / jnp.where(can_fit, denom, 1.0)
    inst = slope * config.fft_size / (2 * np.pi)
    tos = TIMING_ALPHA * inst + (1 - TIMING_ALPHA) * state.timing_offset_samples
    max_t = 50.0 * (config.fft_size / 512.0)
    tos = jnp.clip(tos, -max_t, max_t)
    tos = jnp.where(can_fit, tos, state.timing_offset_samples)

    # Coherent timing fix: de-rotate pilots, interpolate, re-rotate all bins.
    coherent = not is_differential(config.modulation)
    if coherent:
        tfix = (jnp.abs(tos) > 0.1)[:, None]
        kph = 2 * np.pi * jnp.asarray(cm.pilot_k)[None, :] * tos[:, None] / config.fft_size
        ce = ce.at[:, pilot_idx].multiply(
            jnp.where(tfix, jnp.exp(-1j * kph.astype(jnp.float32)), 1.0))

    ce = _interpolate_channel(config, ce)

    if coherent:
        tfix = (jnp.abs(tos) > 0.1)[:, None]
        kph = 2 * np.pi * jnp.asarray(cm.pilot_k)[None, :] * tos[:, None] / config.fft_size
        ce = ce.at[:, pilot_idx].multiply(
            jnp.where(tfix, jnp.exp(1j * kph.astype(jnp.float32)), 1.0))
        kphd = 2 * np.pi * jnp.asarray(cm.data_k)[None, :] * tos[:, None] / config.fft_size
        ce = ce.at[:, jnp.asarray(cm.data_idx)].multiply(
            jnp.where(tfix, jnp.exp(1j * kphd.astype(jnp.float32)), 1.0))

    # Noise variance / SNR EMA.
    upd = (noise_count > 1) & (noise_sum > 0)
    nv = jnp.where(upd, jnp.maximum(noise_sum / jnp.maximum(noise_count - 1, 1), 1e-6),
                   state.noise_variance)
    inst_snr = jnp.clip(signal_power / jnp.maximum(nv, 1e-30), 0.1, 10000.0)
    snr = jnp.where(upd, SNR_ALPHA * inst_snr + (1 - SNR_ALPHA) * state.estimated_snr_linear,
                    state.estimated_snr_linear)

    return state._replace(
        channel_estimate=ce,
        pilot_phase_correction=ppc,
        prev_pilot_phases=h_ls,
        have_prev_pilots=jnp.ones_like(state.have_prev_pilots),
        carrier_phase_correction=cpc,
        carrier_phase_initialized=initialized,
        noise_variance=nv,
        estimated_snr_linear=snr,
        snr_symbol_count=state.snr_symbol_count + 1,
        symbols_since_sync=ssc,
        freq_offset_hz=foh,
        freq_offset_filtered=fof,
        timing_offset_samples=tos,
    )


@functools.lru_cache(maxsize=None)
def _interp_arrays(config: ModemConfig):
    """Static interpolation table (demodulator.cpp:137-193): per data carrier
    the neighbouring pilot bins and blend factor.  Missing neighbours are
    encoded by clamping to the existing one with alpha forced to 0/1."""
    neg = config.num_carriers // 2
    pos = (config.num_carriers + 1) // 2
    carriers = []
    count = 0
    for i in range(-neg, pos + 1):
        if i == 0:
            continue
        fft_i = (i + config.fft_size) % config.fft_size
        carriers.append((fft_i, count % config.pilot_spacing == 0))
        count += 1
    data_bins, lower, upper, alphas, has_l, has_u = [], [], [], [], [], []
    for ci, (bin_i, is_p) in enumerate(carriers):
        if is_p:
            continue
        lo = next(((j, carriers[j][0]) for j in range(ci - 1, -1, -1)
                   if carriers[j][1]), None)
        up = next(((j, carriers[j][0]) for j in range(ci + 1, len(carriers))
                   if carriers[j][1]), None)
        a = 0.5
        if lo and up and up[0] != lo[0]:
            a = (ci - lo[0]) / (up[0] - lo[0])
        data_bins.append(bin_i)
        lower.append(lo[1] if lo else (up[1] if up else bin_i))
        upper.append(up[1] if up else (lo[1] if lo else bin_i))
        alphas.append(a)
        has_l.append(lo is not None)
        has_u.append(up is not None)
    return (np.asarray(data_bins, np.int32), np.asarray(lower, np.int32),
            np.asarray(upper, np.int32), np.asarray(alphas, np.float32),
            np.asarray(has_l), np.asarray(has_u))


def _interpolate_channel(config: ModemConfig, ce: jnp.ndarray) -> jnp.ndarray:
    """interpolateChannel (channel_equalizer.cpp:601-631): linear between
    pilots, nearest-pilot when the inter-pilot phase jump exceeds pi/2."""
    bins, lo, up, a, has_l, has_u = _interp_arrays(config)
    if len(bins) == 0:
        return ce
    H1 = ce[:, jnp.asarray(lo)]
    H2 = ce[:, jnp.asarray(up)]
    pd = H2 * jnp.conj(H1)
    phase_diff = jnp.abs(jnp.arctan2(pd.imag, pd.real))
    a = jnp.asarray(a)[None, :]
    lin = (1.0 - a) * H1 + a * H2
    nearest = jnp.where(a < 0.5, H1, H2)
    both = jnp.asarray(has_l & has_u)[None, :]
    interp = jnp.where(phase_diff > PHASE_INTERP_THRESHOLD, nearest, lin)
    only_l = jnp.asarray(has_l & ~has_u)[None, :]
    val = jnp.where(both, interp, jnp.where(only_l, H1, H2))
    return ce.at[:, jnp.asarray(bins)].set(val.astype(jnp.complex64))


def equalize(config: ModemConfig, mod: Modulation, state: DemodState,
             fd: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(channel_equalizer.cpp:728-855) -> (equalized [B,C], noise_var [B,C])."""
    cm = carriers_mod.carrier_map(config)
    didx = jnp.asarray(cm.data_idx)
    rx = fd[:, :len(cm.data_idx)]   # compact used-bins layout from to_baseband_fd
    h = state.channel_estimate[:, didx]
    hp = jnp.abs(h) ** 2
    nv = state.noise_variance[:, None]

    if is_differential(mod):
        kph = (2 * np.pi * jnp.asarray(cm.data_k)[None, :]
               * state.timing_offset_samples[:, None] / config.fft_size)
        tc = jnp.exp(1j * kph.astype(jnp.float32))
        ppc = state.pilot_phase_correction[:, None]
        good = hp > 1e-6
        eq = jnp.where(good, rx * jnp.conj(h) / jnp.maximum(hp, 1e-30), rx) * ppc * tc
        cnv = jnp.where(good, nv / jnp.maximum(hp, 1e-30), MAX_CARRIER_NOISE_VAR)
        cnv = jnp.clip(cnv, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)
        return eq.astype(jnp.complex64), cnv

    # Coherent MMSE with deep-fade soft erasure.  With the adaptive
    # equalizer enabled, the LMS/RLS weights (seeded from training, then
    # decision-directed-updated per symbol in dd_update) replace the
    # pilot-tracked channel estimate for EQUALIZATION
    # (channel_equalizer.cpp:773-791), but fade detection stays on the
    # pilot-tracked estimate (the reference's fade loop always reads
    # channel_estimate): decision errors can drive a weight away from a
    # faded carrier's true gain, which would hide the fade from a
    # weights-based mask.
    hp_fade = hp
    if config.adaptive_eq_enabled:
        h = state.eq_weights
        hp = jnp.abs(h) ** 2
    denom = hp + nv
    good = denom >= 1e-10
    eq = jnp.where(good, jnp.conj(h) * rx / jnp.maximum(denom, 1e-30), 0.0)
    cnv = jnp.where(good,
                    jnp.clip(nv / (hp + 1e-6), MIN_CARRIER_NOISE_VAR,
                             MAX_CARRIER_NOISE_VAR),
                    MAX_CARRIER_NOISE_VAR)
    avg_hp = hp_fade.mean(-1, keepdims=True)
    cnv = jnp.where(hp_fade < FADE_THRESHOLD_RATIO * avg_hp,
                    MAX_CARRIER_NOISE_VAR, cnv)
    return eq.astype(jnp.complex64), cnv


def dd_update(config: ModemConfig, mod: Modulation, state: DemodState,
              rx: jnp.ndarray, eq: jnp.ndarray) -> DemodState:
    """Decision-directed LMS/RLS weight update
    (channel_equalizer.cpp:705-727 update rules, :794-801 call site):
    the hard decision on this symbol's equalized output becomes the
    reference signal for the per-carrier weight adaptation.  rx is the
    un-equalized data-carrier spectrum [B, C]."""
    if not config.decision_directed:
        return state
    d = demap_ops.hard_decision(mod, eq)
    w = state.eq_weights
    err = rx - w * d
    if config.adaptive_eq_use_rls:
        P, dn = state.rls_P, jnp.abs(d) ** 2
        lam = jnp.float32(config.rls_lambda)
        k = P / (lam + P * dn)
        w = w + k * jnp.conj(d) * err
        P = jnp.clip((P - k * dn * P) / lam, 1e-3, 1e3)
        return state._replace(eq_weights=w.astype(jnp.complex64), rls_P=P)
    w = w + jnp.float32(config.lms_mu) * jnp.conj(d) * err
    return state._replace(eq_weights=w.astype(jnp.complex64))


def demodulate_symbol(config: ModemConfig, mod: Modulation, state: DemodState,
                      eq: jnp.ndarray, cnv: jnp.ndarray
                      ) -> tuple[jnp.ndarray, DemodState]:
    """(demodulator.cpp:199-435) -> (llrs [B, C*bc], state).

    Note: the reference's decision-directed tracking block
    (demodulator.cpp:362-434) is inert — it reads dbpsk_prev_equalized[i]
    AFTER the demap loop has already overwritten it with the current symbol,
    so every measured phase error is identically zero.  We therefore omit it.
    """
    nv = cnv * demap_ops.CE_MARGIN.get(mod, 1.0)
    if is_differential(mod):
        llrs = demap_ops.demap(mod, eq, nv, prev=state.dbpsk_prev)
        state = state._replace(dbpsk_prev=eq)
    else:
        llrs = demap_ops.demap(mod, eq, nv)
    B = eq.shape[0]
    return llrs.reshape(B, -1), state


# ---------------------------------------------------------------------------
# Presynced frame pipeline (processPresynced, demodulator.cpp:854-985)
# ---------------------------------------------------------------------------

def estimate_channel_from_lts(config: ModemConfig, state: DemodState,
                              training: jnp.ndarray,
                              t0_base: int = 0,
                              t0_stride: int | None = None,
                              image_cancel: bool = False,
                              taper: bool = False) -> DemodState:
    """(channel_equalizer.cpp:77-328): LS estimates from each training
    symbol; data carriers take the LAST symbol's H (closest in time to the
    first data symbol), pilots take the average; SNR seeded from |H|avg^2 /
    noise_variance; snr_symbol_count set to the training count.

    training: [B, n_sym, L] (L may be N+CP for guard-less preamble LTS).
    Symbol s demixes at mixer time t0_base + s * t0_stride (default: the
    window length L, i.e. contiguously-mixed training like the chirp path's
    generateTrainingSymbols).  The Cox preamble instead mixed ONE LTS buffer
    at [plen, 2plen) and repeated it (modulator.cpp:479-531 quirk), so both
    repeats must demix at the SAME offset (t0_base=plen, t0_stride=0) —
    otherwise the per-symbol estimates differ by 2*pi*fc*plen/fs (exactly pi
    for the default config) and the pilot AVERAGE destructively cancels."""
    cm = carriers_mod.carrier_map(config)
    B, n_sym, L = training.shape
    stride = L if t0_stride is None else t0_stride
    tx_data = cm.sync_seq[np.arange(len(cm.data_idx)) % len(cm.sync_seq)]
    tx_data = jnp.asarray(tx_data)

    ce = state.channel_estimate
    h_data_last = None
    h_pilot_sum = jnp.zeros((B, max(len(cm.pilot_idx), 1)), jnp.complex64)
    Cd = len(cm.data_idx)
    for s in range(n_sym):
        fd, state = to_baseband_fd(config, state, training[:, s],
                                   t0_base + s * stride,
                                   image_cancel=image_cancel, taper=taper)
        h_data_last = fd[:, :Cd] / tx_data[None, :]
        if len(cm.pilot_idx):
            h_pilot_sum = h_pilot_sum + fd[:, Cd:] / jnp.asarray(cm.pilot_seq)[None, :]

    ce = ce.at[:, jnp.asarray(cm.data_idx)].set(h_data_last)
    if len(cm.pilot_idx):
        ce = ce.at[:, jnp.asarray(cm.pilot_idx)].set(h_pilot_sum / n_sym)

    h_mag_avg = jnp.abs(h_data_last).mean(-1)
    snr = jnp.clip(h_mag_avg ** 2 / jnp.maximum(state.noise_variance, 1e-10),
                   0.1, 10000.0)
    ok = (h_mag_avg > 1e-6) & (state.noise_variance > 1e-10)
    snr = jnp.where(ok, snr, state.estimated_snr_linear)

    return state._replace(
        channel_estimate=ce,
        estimated_snr_linear=snr,
        snr_symbol_count=jnp.full_like(state.snr_symbol_count, n_sym),
        # Seed the adaptive-equalizer weights from the training estimate
        # (channel_equalizer.cpp:570-580 inits lms_weights from the
        # pilot-based estimate during the first symbols); harmless when
        # adaptive_eq_enabled is off.
        eq_weights=h_data_last.astype(jnp.complex64),
    )


@functools.partial(jax.jit, static_argnames=("config", "mod", "t0_lts",
                                             "t0_data", "t0_lts_stride",
                                             "front", "n_bits"))
def demodulate_with_lts(config: ModemConfig, mod: Modulation,
                        lts: jnp.ndarray, data: jnp.ndarray, cfo_hz,
                        initial_phase, t0_lts: int = 0,
                        t0_data: int = 0,
                        t0_lts_stride: int | None = None,
                        front: str = "analytic",
                        n_bits: int | None = None):
    """Jitted LTS-channel-estimate + data-scan path for pre-sliced segments
    (the Cox decoders): lts [B, n_sym, L], data [B, S, sym_len], both cut
    from the SAME maybe_analytic-converted span.  Jitted as a unit."""
    B = lts.shape[0]
    q256 = _hi_order(mod)
    # front == "real": the span is the raw real passband (no Hilbert) and
    # the rect window keeps the conjugate image exactly bin-orthogonal
    # (fc*N/fs is integer on every plan; image bins 465-495 vs signal
    # +-16 on the 512 grid) — the reference demod's own front-end
    # (channel_equalizer.cpp:19-71 mixes the real signal, no analytic
    # mask anywhere).  Tukey/image-cancel would BREAK that orthogonality,
    # so they stay off.
    real = front == "real"
    ic = (q256 and QAM256_RX == "real") and not real
    taper = q256 and not real
    state = init_state(config, B, cfo_hz, initial_phase)
    state = estimate_channel_from_lts(config, state, lts, t0_base=t0_lts,
                                      t0_stride=t0_lts_stride,
                                      image_cancel=ic, taper=taper)
    # EVERY coherent no-pilot mode takes the refined two-pass path: the
    # scan path has no per-symbol tracking without pilots (the LTS-only H
    # is frozen for the whole frame), which loses QAM16/32 from +-20 ppm
    # of sample-clock skew (tools/test_sro.py).  The data window keeps
    # each tier's established choice via ``taper``.
    if (not is_differential(mod)
            and len(carriers_mod.carrier_map(config).pilot_idx) == 0
            and not config.adaptive_eq_enabled):
        llrs = _demod_coherent_refined(config, mod, state, data,
                                       t0_base=t0_data, front=front,
                                       n_bits=n_bits, taper=taper)
        return llrs, state
    state, llrs = _scan_data_symbols(config, mod, state, data,
                                     t0_base=t0_data, front=front,
                                     n_bits=n_bits)
    return llrs, state


def _live_carrier_mask(mod: Modulation, S: int, Cd: int,
                       n_bits: int | None) -> np.ndarray:
    """[S, Cd] f32 host constant: 1 where the TX filled the carrier.
    map_bits_to_symbols (modulator.py) leaves carriers whose bits lie
    entirely past the input EMPTY (complex zero) — on a 4000-byte QAM256
    R5/6 NVIS frame the final symbol is 52/59 dead carriers, and feeding
    their hard 'decisions' (noise snapped to inner-ring points) into the
    rank-1 LS collapsed |g[last]| to ~0.79, deterministically corrupting
    the last codeword at ANY SNR (measured at 80 dB; bits 3,7 of each
    byte).  n_bits is static per (S,) compile key: both derive from the
    codeword count, so masking adds no new jit cache entries."""
    if n_bits is None:
        return np.ones((S, Cd), np.float32)
    bc = bits_per_symbol(mod)
    first_bit = np.arange(S * Cd).reshape(S, Cd) * bc
    return (first_bit < n_bits).astype(np.float32)


def _demod_coherent_refined(config: ModemConfig, mod: Modulation,
                            state: DemodState, data: jnp.ndarray,
                            t0_base, front: str = "analytic",
                            n_bits: int | None = None,
                            taper: bool | None = None) -> jnp.ndarray:
    """Two-pass no-pilot coherent demod with decision-directed channel
    refinement — every coherent no-pilot mode routes here (round 4: the
    scan path has NO per-symbol tracking without pilots, so NVIS QAM16/32
    degraded from +-20 ppm of TX/RX clock skew; the dual PLL below holds
    them to +-100 ppm like the hi-order modes).  ``taper`` follows the
    caller's window choice so the data analysis window always matches the
    LTS estimate's (<=32QAM keeps rect; hi-order keeps folded-Tukey).

    Under a true (SSB) CFO the LTS-only channel estimate is contaminated
    by the Hilbert ringing of the LTS<->data boundary — a PAYLOAD-dependent
    error reaching ~-27 dB on the lowest carriers (measured lane-to-lane H
    spread with a shared preamble; identically zero at CFO 0), which
    multiplies every data symbol and is the binding ICI floor for 256QAM.
    Pilots would track it away, but the NVIS frame has none — so refit the
    per-carrier complex gain from ALL S data symbols (LS against hard
    decisions): averaging over S >> 2 symbols beats the 2-symbol LTS
    estimate by ~10*log10(S/2) dB on both ringing and noise.  Decisions
    use ZF equalization (the MMSE denominator's default-nv shrink moves
    256QAM's outer rings by ~a decision distance); the final LLRs keep
    the MMSE + CE_MARGIN semantics of the scan path."""
    cm = carriers_mod.carrier_map(config)
    B, S, L = data.shape
    Cd = len(cm.data_idx)
    if taper is None:
        taper = front != "real"
    hi = _hi_order(mod)

    def step(carry, xs):
        st = carry
        sym, s_idx = xs
        fd, st = to_baseband_fd(
            config, st, sym, t0_base + s_idx * L,
            image_cancel=(hi and QAM256_RX == "real" and front != "real"),
            taper=taper)
        return st, fd

    xs = (jnp.moveaxis(data, 1, 0), jnp.arange(S))
    _, fds = jax.lax.scan(step, state, xs)               # [S, B, Cu]
    fd = jnp.moveaxis(fds, 0, 1)[:, :, :Cd]              # [B, S, Cd]

    # TX-dead carriers (partial last symbol) must not feed the fits: their
    # hard decisions are noise snapped to constellation points.
    live = jnp.asarray(_live_carrier_mask(mod, S, Cd, n_bits))[None]  # [1,S,Cd]

    # Alternating rank-1 LS fit fd ~= g[s] * h[c] * d[s,c]: per-carrier
    # complex gain h refit from ALL S symbols PLUS a per-symbol common
    # factor g — the ~1 s 32-codeword frame accrues residual-CFO phase
    # drift (~0.1 rad at the detector's ~15 mHz estimate error), about a
    # decision distance on 256QAM's outer ring, and this frame has no
    # pilots to track it.  g is estimated from all Cd decisions jointly
    # (robust) and absorbs drift + any slow amplitude wander.
    didx = jnp.asarray(cm.data_idx)
    h = state.channel_estimate[:, didx][:, None, :]      # [B, 1, Cd]
    nv = state.noise_variance[:, None, None]

    # Seed g with a decision-directed PLL scan: a worse-than-usual CFO
    # estimate drifts past a decision distance by mid-frame, where the
    # one-shot per-symbol fit's initial decisions are already wrong and
    # the alternating LS sticks there (measured: symbols 35+ of a 44-
    # symbol frame decode as noise while 0-34 are clean).  The loop only
    # ever tracks the small per-symbol increment, so its decisions stay
    # inside the correct cell all the way down the frame.
    #
    # The loop is DUAL: common phase (CFO residual) AND a per-bin phase
    # slope (symbol-TIMING drift).  A TX/RX sample-clock offset of eps
    # slides the analysis window by eps*L samples per symbol; a window
    # shift of delta rotates signed bin k by exp(-j*2pi*k*delta/N) — a
    # slope in k that the rank-1 g[s]*h[c] model CANNOT absorb (measured:
    # the no-pilot NVIS QAM256 R5/6 row dies at +-20 ppm without this,
    # ~42 deg at the edge bins after 4 samples of drift; consumer
    # soundcards run 20-100 ppm apart, tools/test_sro.py).  Both loops
    # are second-order, so a constant-rate ramp tracks with zero
    # steady-state error.
    h2 = h[:, 0, :]                                      # [B, Cd]
    hp2 = jnp.maximum(jnp.abs(h2) ** 2, 1e-12)
    kbin = jnp.asarray(_used_bins_k(config)[:Cd])        # [Cd] signed bins
    kb2sum_w = 1e-12

    def pll_step(carry, xs_s):
        fd_s, m_s = xs_s                                 # [B, Cd], [1, Cd]
        phi, om, psi, ups = carry                        # [B] each
        ang = phi[:, None] + psi[:, None] * kbin[None, :]
        rot = jnp.exp(-1j * ang.astype(jnp.complex64))
        z = fd_s * rot
        d_s = demap_ops.hard_decision(mod, z * jnp.conj(h2) / hp2)
        e = z * jnp.conj(h2 * d_s) * m_s                 # [B, Cd]
        ec = e.sum(-1)
        err = jnp.arctan2(ec.imag, ec.real)
        # Timing-slope error: weighted LS fit of the residual per-carrier
        # phase against the signed bin number (common part removed first,
        # so the angles are small increments and never wrap).
        th = e * jnp.exp(-1j * err.astype(jnp.complex64))[:, None]
        resid_ph = jnp.arctan2(th.imag, th.real)
        w = jnp.abs(e)
        err_s = ((w * resid_ph * kbin[None, :]).sum(-1)
                 / jnp.maximum((w * kbin[None, :] ** 2).sum(-1), kb2sum_w))
        om = om + 0.05 * err
        phi_s = phi + err                                # best phase for s
        phi = phi + om + 0.3 * err
        ups = ups + 0.05 * err_s
        psi_s = psi + err_s                              # best slope for s
        psi = psi + ups + 0.3 * err_s
        return (phi, om, psi, ups), (phi_s, psi_s)

    zero = jnp.zeros((B,), jnp.float32)
    _, (phis, psis) = jax.lax.scan(pll_step, (zero, zero, zero, zero),
                                   (jnp.moveaxis(fd, 0, 1),
                                    jnp.moveaxis(live, 0, 1)))  # [S, B] x2
    # Take the tracked timing slope OUT of fd so the rank-1 model (and the
    # residual-noise estimator) see a drift-free grid; the common phase
    # stays in g's seed exactly as before.
    fd = fd * jnp.exp(-1j * (jnp.moveaxis(psis, 0, 1)[:, :, None]
                             * kbin[None, None, :]).astype(jnp.complex64))
    g = jnp.exp(1j * jnp.moveaxis(phis, 0, 1))[:, :, None].astype(
        jnp.complex64)                                   # [B, S, 1]
    d = None
    for _ in range(3):
        G = g * h
        Gp = jnp.maximum(jnp.abs(G) ** 2, 1e-12)
        d = demap_ops.hard_decision(mod, fd * jnp.conj(G) / Gp) * live
        hd = h * d
        g = ((fd * jnp.conj(hd)).sum(-1, keepdims=True)
             / jnp.maximum((jnp.abs(hd) ** 2).sum(-1, keepdims=True), 1e-30))
        gd = g * d
        h = ((fd * jnp.conj(gd)).sum(1, keepdims=True)
             / jnp.maximum((jnp.abs(gd) ** 2).sum(1, keepdims=True), 1e-30))

    # Honest per-carrier noise: the decision residual measures EACH
    # carrier's actual disturbance (thermal + residual image + Hilbert
    # ringing), which is far from white here — the lowest carriers carry
    # ~15 dB more ringing than the median.  Without this, a residual-ICI
    # symbol error on a low carrier demaps at the +-10 LLR clip and
    # min-sum converges to a WRONG valid codeword (measured: 1-2
    # max-confidence wrong bits flip R5/6); with it those carriers'
    # LLRs deflate to their true reliability and the decoder walks
    # through.  Pilot configs get the same effect from pilot tracking.
    G = g * h
    resid = (fd - G * d) * live
    cnt = jnp.maximum(live.sum(1, keepdims=True), 1.0)
    r = (jnp.abs(resid) ** 2).sum(1, keepdims=True) / cnt  # [B, 1, Cd]
    r = jnp.maximum(r, 0.25 * nv)

    hp = jnp.abs(G) ** 2
    eq = jnp.conj(G) * fd / jnp.maximum(hp + nv, 1e-30)
    cnv = jnp.clip(r / (hp + 1e-6), MIN_CARRIER_NOISE_VAR,
                   MAX_CARRIER_NOISE_VAR)
    nv_eff = cnv * demap_ops.CE_MARGIN.get(mod, 1.0)
    llrs = demap_ops.demap(mod, eq.astype(jnp.complex64), nv_eff)
    return llrs.reshape(B, -1)


def _edge_tapered(mod: Modulation, span: jnp.ndarray,
                  lead: int, tail: int) -> jnp.ndarray:
    """Raised-cosine taper over the lead/tail MARGIN samples of a real span
    before the Hilbert FFT.  maybe_analytic's FFT treats the span as
    circular: a mid-signal slice edge is a full-amplitude discontinuity at
    the wrap point whose Hilbert ringing (~1/(pi*d) per sample) integrates
    to ~-32 dB over the first LTS window at d >= cp — a deterministic,
    payload-dependent EVM floor that binds 64/256QAM on SHORT frames (long
    NVIS frames amortize it over 44 symbols and the DD refinement deflates
    the damaged carriers' LLRs).  Tapering the margin to zero removes the
    wrap discontinuity entirely; the margin keeps the taper away from the
    used symbols.  Differential modes never convert (maybe_analytic no-op)
    and are left untouched."""
    if is_differential(mod) or (lead == 0 and tail == 0):
        return span
    T = span.shape[-1]
    w = np.ones(T, np.float32)
    if lead > 0:
        w[:lead] = np.sin(np.pi * (np.arange(lead) + 0.5) / (2 * lead)) ** 2
    if tail > 0:
        w[T - tail:] = np.sin(
            np.pi * (np.arange(tail)[::-1] + 0.5) / (2 * tail)) ** 2
    return span * jnp.asarray(w)[None, :]


@functools.partial(jax.jit, static_argnames=("config", "mod", "n_lts", "S",
                                             "lead", "tail", "front",
                                             "n_bits"))
def demodulate_span(config: ModemConfig, mod: Modulation, span: jnp.ndarray,
                    cfo_hz, initial_phase, n_lts: int, S: int,
                    lead: int = 0, tail: int = 0, front: str = "analytic",
                    n_bits: int | None = None):
    """[B, T] real span starting ``lead`` samples BEFORE the first LTS and
    extending ``tail`` samples past the data end -> (llrs, state).
    Conversion (maybe_analytic) and segment slicing happen INSIDE one jit:
    round-tripping the converted complex span through the host trips the
    accelerator transport's complex-array limitations.  The margins exist
    to move the span's slice edges away from the used symbols (see
    _edge_tapered); pass 0/0 for the legacy exact slice.  front="real"
    skips the Hilbert entirely (and the taper, which only guards Hilbert
    wrap ringing) — see demodulate_with_lts."""
    if front == "real":
        span = span.astype(jnp.complex64)
    else:
        span = maybe_analytic(mod, _edge_tapered(mod, span, lead, tail))
    plen = config.fft_size + config.cyclic_prefix
    B = span.shape[0]
    lts = span[:, lead:lead + n_lts * plen].reshape(B, n_lts, plen)
    d0 = n_lts * plen
    data = span[:, lead + d0:lead + d0 + S * config.symbol_duration].reshape(
        B, S, config.symbol_duration)
    # Cox preamble quirk: TX mixed ONE LTS at [plen, 2plen) and repeated it,
    # so every repeat demixes at t0 = plen (stride 0) — see
    # estimate_channel_from_lts.
    return demodulate_with_lts(config, mod, lts, data, cfo_hz, initial_phase,
                               t0_lts=plen, t0_data=d0, t0_lts_stride=0,
                               front=front, n_bits=n_bits)


@functools.partial(jax.jit, static_argnames=("config", "mod", "n_lts", "S",
                                             "lead", "tail", "front"))
def equalized_symbols_span(config: ModemConfig, mod: Modulation,
                           span: jnp.ndarray, cfo_hz, initial_phase,
                           n_lts: int, S: int, lead: int = 0, tail: int = 0,
                           front: str = "analytic"):
    """Constellation variant of demodulate_span -> [B, S, C, 2] f32
    (real, imag) — the accelerator transport cannot download multi-dim
    complex arrays, so the split happens inside the jit."""
    if front == "real":
        span = span.astype(jnp.complex64)
    else:
        span = maybe_analytic(mod, _edge_tapered(mod, span, lead, tail))
    plen = config.fft_size + config.cyclic_prefix
    B = span.shape[0]
    lts = span[:, lead:lead + n_lts * plen].reshape(B, n_lts, plen)
    d0 = n_lts * plen
    data = span[:, lead + d0:lead + d0 + S * config.symbol_duration].reshape(
        B, S, config.symbol_duration)
    eq = equalized_symbols(config, mod, lts, data, cfo_hz, initial_phase,
                           t0_lts=plen, t0_data=d0, t0_lts_stride=0,
                           front=front)
    return jnp.stack([eq.real, eq.imag], axis=-1)


@functools.partial(jax.jit, static_argnames=("config", "mod", "t0_lts",
                                             "t0_data", "t0_lts_stride",
                                             "front"))
def equalized_symbols(config: ModemConfig, mod: Modulation,
                      lts: jnp.ndarray, data: jnp.ndarray, cfo_hz,
                      initial_phase, t0_lts: int = 0, t0_data: int = 0,
                      t0_lts_stride: int | None = None,
                      front: str = "analytic"):
    """Equalized constellation points [B, S, C] for observability
    (OFDMDemodulator::getConstellationSymbols; GUI constellation widget).
    Same pipeline as demodulate_with_lts but returns the equalizer output
    instead of LLRs."""
    B = lts.shape[0]
    L = data.shape[-1]
    q256 = _hi_order(mod)
    real = front == "real"
    ic = (q256 and QAM256_RX == "real") and not real
    taper = q256 and not real
    state = init_state(config, B, cfo_hz, initial_phase)
    state = estimate_channel_from_lts(config, state, lts, t0_base=t0_lts,
                                      t0_stride=t0_lts_stride,
                                      image_cancel=ic, taper=taper)
    has_pilots = len(carriers_mod.carrier_map(config).pilot_idx) > 0

    adaptive = config.adaptive_eq_enabled and not is_differential(mod)
    Cd = len(carriers_mod.carrier_map(config).data_idx)

    def step(carry, xs):
        st = carry
        sym, s_idx = xs
        fd, st = to_baseband_fd(config, st, sym, t0_data + s_idx * L,
                                image_cancel=ic, taper=taper)
        if has_pilots:
            st = update_channel_estimate(config, st, fd)
        eq, cnv = equalize(config, mod, st, fd)
        if adaptive:
            # Keep the exported constellation in lockstep with what the
            # decoder actually equalizes (same dd_update as
            # _scan_data_symbols).
            st = dd_update(config, mod, st, fd[:, :Cd], eq)
        _, st = demodulate_symbol(config, mod, st, eq, cnv)
        return st, eq

    S = data.shape[1]
    xs = (jnp.moveaxis(data, 1, 0), jnp.arange(S))
    _, eq = jax.lax.scan(step, state, xs)
    return jnp.moveaxis(eq, 0, 1)


@functools.partial(jax.jit, static_argnames=("config", "mod", "training_symbols",
                                             "num_data_symbols"))
def demodulate_presynced(config: ModemConfig, mod: Modulation,
                         samples: jnp.ndarray, cfo_hz, initial_phase,
                         training_symbols: int, num_data_symbols: int):
    """Full presynced RX for a batch of frames.

    Args:
      samples: [B, T] float32 passband, aligned at training start;
               T >= (training_symbols + num_data_symbols) * symbol_duration.
      cfo_hz, initial_phase: [B] external CFO estimate + accumulated phase
               (setFrequencyOffsetWithPhase semantics, demodulator.cpp:816).
    Returns:
      (llrs [B, num_data_symbols * bits_per_ofdm_symbol], final DemodState)
    """
    state, data = _presynced_state(config, mod, samples, cfo_hz,
                                   initial_phase, training_symbols,
                                   num_data_symbols)
    L = config.symbol_duration
    has_pilots = len(carriers_mod.carrier_map(config).pilot_idx) > 0
    if is_differential(mod) and not has_pilots:
        # FAST PATH: with no pilots the carry never changes (H fixed from the
        # LTS, nv fixed, ppc = 1, the reference's DD block is inert) and the
        # differential reference is just the previous symbol — so all symbols
        # demodulate in ONE shot with a shifted-multiply prev chain instead
        # of a sequential scan.  Bit-identical to the scan path.
        llrs = _demod_differential_parallel(config, mod, state, data,
                                            t0_base=training_symbols * L)
        return llrs, state
    if (not is_differential(mod) and not has_pilots
            and not config.adaptive_eq_enabled):
        # Coherent no-pilot: refined two-pass with the dual PLL (phase +
        # timing slope) — same routing as demodulate_with_lts; this
        # function's window choice (Tukey only at QAM256) is preserved.
        llrs = _demod_coherent_refined(config, mod, state, data,
                                       t0_base=training_symbols * L,
                                       taper=(mod == Modulation.QAM256))
        return llrs, state
    state, llrs = _scan_data_symbols(config, mod, state, data,
                                     t0_base=training_symbols * L)
    return llrs, state


def equalized_presynced(config: ModemConfig, mod: Modulation,
                        samples: jnp.ndarray, training_symbols: int,
                        num_data_symbols: int, cfo_hz=0.0, initial_phase=0.0):
    """demodulate_presynced's no-pilot differential fast path up to the
    demapper: (eq [B, S, C] equalized data symbols, prev [B, S, C] their
    differential references, cnv [B, 1, C] per-carrier noise variance).

    These are the values the LLRs are made from, before the demapper's
    +-10 clip, so backends can be compared on them directly."""
    if (not is_differential(mod)
            or len(carriers_mod.carrier_map(config).pilot_idx) > 0):
        raise ValueError("equalized_presynced covers the no-pilot "
                         "differential path only")
    state, data = _presynced_state(config, mod, samples, cfo_hz,
                                   initial_phase, training_symbols,
                                   num_data_symbols)
    return _differential_parallel_eq(
        config, state, data, t0_base=training_symbols * config.symbol_duration)


def _presynced_state(config: ModemConfig, mod: Modulation,
                     samples: jnp.ndarray, cfo_hz, initial_phase,
                     training_symbols: int, num_data_symbols: int):
    """The LTS-estimated DemodState and the [B, S, L] data symbols."""
    B = samples.shape[0]
    L = config.symbol_duration
    state = init_state(config, B, cfo_hz, initial_phase)

    # Coherent modes work on the half-scaled analytic signal: a real
    # passband carries a negative-frequency image that is FFT-bin-aligned
    # only at zero CFO — under CFO it leaks ICI into every bin, growing with
    # the offset (the reference demodulates the real signal and its coherent
    # modes were only validated near zero CFO).  The 0.5 scale keeps the
    # positive-frequency amplitude identical to the real signal's, so all
    # channel/noise/LLR calibrations (and zero-CFO golden parity) hold.
    samples = maybe_analytic(mod, samples)

    if training_symbols > 0:
        tr = samples[:, :training_symbols * L].reshape(B, training_symbols, L)
        state = estimate_channel_from_lts(
            config, state, tr,
            image_cancel=(mod == Modulation.QAM256 and QAM256_RX == "real"),
            taper=(mod == Modulation.QAM256))

    data = samples[:, training_symbols * L:(training_symbols + num_data_symbols) * L]
    return state, data.reshape(B, num_data_symbols, L)


@functools.lru_cache(maxsize=None)
def _analysis_tensor(config: ModemConfig, t0_base: int, S: int):
    """conj(NCO downmix) x DFT rows of the data bins (CP region zeroed), so
    rx[b,s,c] = sum_l data[b,s,l] * corr * M[s,l,c].  Returned as TWO real
    f32 [S, L, C] tensors (Mr, Mi) for real einsums."""
    cm = carriers_mod.carrier_map(config)
    N, cp = config.fft_size, config.cyclic_prefix
    L = config.symbol_duration
    osc = mixer_ops.osc_fixed(config.center_freq, config.sample_rate,
                              S * L, offset=t0_base).reshape(S, L)
    n_idx = np.arange(L) - cp
    live = (n_idx >= 0) & (n_idx < N)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N,
                                      np.asarray(cm.data_idx, np.float64)) / N)
    W = np.where(live[:, None], W, 0.0)                    # [L, C]
    M = np.conj(osc)[:, :, None] * W[None, :, :]
    return M.real.astype(np.float32), M.imag.astype(np.float32)


def _demod_differential_parallel(config: ModemConfig, mod: Modulation,
                                 state: DemodState, data: jnp.ndarray,
                                 t0_base: int) -> jnp.ndarray:
    """All-symbols-at-once differential demod for the no-pilot configs."""
    from ..ops import demap as demap_ops
    eq, prev, cnv = _differential_parallel_eq(config, state, data, t0_base)
    nv_eff = cnv * demap_ops.CE_MARGIN.get(mod, 1.0)
    llrs = demap_ops.demap(mod, eq, nv_eff, prev=prev)
    return llrs.reshape(data.shape[0], -1)


def _differential_parallel_eq(config: ModemConfig, state: DemodState,
                              data: jnp.ndarray, t0_base: int):
    """Analysis and equalization of all data symbols at once:
    (eq [B, S, C], prev [B, S, C], cnv [B, 1, C])."""
    cm = carriers_mod.carrier_map(config)
    B, S, L = data.shape
    N, cp = config.fft_size, config.cyclic_prefix

    cfo = state.freq_offset_hz
    Mr, Mi = _analysis_tensor(config, t0_base, S)
    Mr, Mi = jnp.asarray(Mr), jnp.asarray(Mi)
    hi = jax.lax.Precision.HIGHEST
    ee = functools.partial(jnp.einsum, "bsl,slc->bsc", precision=hi)
    dr = data.real if jnp.iscomplexobj(data) else data
    di = data.imag if jnp.iscomplexobj(data) else None

    # Analysis as a sparse contraction: only the C data bins are needed, so
    # downmix + FFT-bin extraction fold into host-constant [S, L, C] real
    # tensors.
    # data may be real passband or the half-scaled analytic signal.  The
    # CFO-correction rotation (per-sample trig over [B, S, L] plus a second
    # einsum pair) only runs when some lane actually has a CFO.
    def with_cfo(_):
        phase_inc = jnp.float32(-2.0 * np.pi / config.sample_rate) * cfo
        i_all = jnp.arange(S * L, dtype=jnp.float32).reshape(S, L)
        corr_phase = (state.freq_phase[:, None, None]
                      + phase_inc[:, None, None] * i_all[None])
        act = (jnp.abs(cfo) > 0.01)[:, None, None]
        corr_phase = jnp.where(act, corr_phase, 0.0)
        c_ph, s_ph = jnp.cos(corr_phase), jnp.sin(corr_phase)
        zr = dr * c_ph if di is None else dr * c_ph - di * s_ph         # [B,S,L]
        zi = dr * s_ph if di is None else dr * s_ph + di * c_ph
        return jax.lax.complex(ee(zr, Mr) - ee(zi, Mi),
                               ee(zr, Mi) + ee(zi, Mr))

    def no_cfo(_):
        if di is None:
            return jax.lax.complex(ee(dr, Mr), ee(dr, Mi))
        return jax.lax.complex(ee(dr, Mr) - ee(di, Mi),
                               ee(dr, Mi) + ee(di, Mr))

    rx = jax.lax.cond(jnp.any(jnp.abs(cfo) > 0.01), with_cfo, no_cfo,
                      None)                                             # [B,S,C]
    didx = jnp.asarray(cm.data_idx)
    h = state.channel_estimate[:, None, didx]
    hp = jnp.abs(h) ** 2
    good = hp > 1e-6
    ppc = state.pilot_phase_correction[:, None, None]
    eq = jnp.where(good, rx * jnp.conj(h) / jnp.maximum(hp, 1e-30), rx) * ppc
    nv = state.noise_variance[:, None, None]
    cnv = jnp.where(good, nv / jnp.maximum(hp, 1e-30), MAX_CARRIER_NOISE_VAR)
    cnv = jnp.clip(cnv, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)

    prev = jnp.concatenate([state.dbpsk_prev[:, None, :], eq[:, :-1, :]],
                           axis=1)
    return eq.astype(jnp.complex64), prev.astype(jnp.complex64), cnv


def _scan_data_symbols(config: ModemConfig, mod: Modulation, state: DemodState,
                       data: jnp.ndarray, t0_base, front: str = "analytic",
                       n_bits: int | None = None):
    """lax.scan over [B, S, L] data symbols starting at mixer time t0_base."""
    B, S, L = data.shape
    has_pilots = len(carriers_mod.carrier_map(config).pilot_idx) > 0

    adaptive = config.adaptive_eq_enabled and not is_differential(mod)
    Cd = len(carriers_mod.carrier_map(config).data_idx)
    q256 = _hi_order(mod)
    real = front == "real"
    ic = (q256 and QAM256_RX == "real") and not real
    taper = q256 and not real

    cm = carriers_mod.carrier_map(config)

    def step(carry, xs):
        state = carry
        sym, s_idx = xs
        fd, state = to_baseband_fd(config, state, sym, t0_base + s_idx * L,
                                   image_cancel=ic, taper=taper)
        if has_pilots:
            state = update_channel_estimate(config, state, fd)
        eq, cnv = equalize(config, mod, state, fd)
        if adaptive:
            state = dd_update(config, mod, state, fd[:, :Cd], eq)
        llrs, state = demodulate_symbol(config, mod, state, eq, cnv)
        if q256 and has_pilots:
            h_ls = fd[:, Cd:] / jnp.asarray(cm.pilot_seq)[None, :]
            hp_d = jnp.abs(state.channel_estimate[:, jnp.asarray(
                cm.data_idx)]) ** 2
            return state, (llrs, eq, cnv, h_ls, hp_d)
        return state, (llrs, eq, cnv)

    xs = (jnp.moveaxis(data, 1, 0), jnp.arange(S))
    state, ys = jax.lax.scan(step, state, xs)

    if q256 and has_pilots:
        # Honest per-carrier noise for the high-order modes in PILOT
        # configs: the engine's 512-FFT carrier plan puts its lowest
        # carriers ~1-2 bins from DC where analytic-mask leakage leaves a
        # deterministic, payload-dependent ~-25 dB disturbance (measured:
        # 3 of 15 carriers 15-25 dB worse than the median at ZERO noise,
        # flat vs CFO).  The scalar pilot noise_variance averages that
        # away, those carriers demap at the +-10 LLR clip, and min-sum
        # converges to a WRONG valid codeword (cw_ok=True, corrupted
        # bytes).  Two per-carrier estimators, combined by max:
        # * decision residual over the whole frame (the refined path's
        #   trick) — unbiased for disturbances below half a decision
        #   distance but SATURATES past it (the residual then measures
        #   distance to the wrong point, measured: max-confidence wrong
        #   bits survive at QAM256);
        # * per-PILOT temporal diffs interpolated to data carriers —
        #   pilots are known symbols, so this estimator never saturates
        #   and un-clips exactly the carriers the residual lies about.
        # The scan's per-symbol cnv (fade erasures) stays as a floor.
        # <=32QAM never feels the floor and keeps the reference-parity
        # single-pass LLRs.
        llrs, eqs, cnvs, h_lss, hp_ds = ys
        eq = jnp.moveaxis(eqs, 0, 1)                     # [B, S, Cd]
        cnv = jnp.moveaxis(cnvs, 0, 1)
        d = demap_ops.hard_decision(mod, eq)
        # TX-dead carriers of a partial last symbol carry no signal; their
        # 'residual' is the full inner-ring distance and would inflate the
        # whole-frame per-carrier noise for REAL bits on the same carrier.
        live = jnp.asarray(_live_carrier_mask(mod, S, Cd, n_bits))[None]
        cnt = jnp.maximum(live.sum(1, keepdims=True), 1.0)
        r = (jnp.abs(eq - d) ** 2 * live).sum(1, keepdims=True) / cnt

        h_ls = jnp.moveaxis(h_lss, 0, 1)                 # [B, S, Np]
        pd = (jnp.abs(jnp.diff(h_ls, axis=1)) ** 2).mean(1)   # [B, Np]
        Wn = jnp.asarray(_pilot_to_data_interp(config))  # [Cd, Np]
        pn_d = pd @ Wn.T                                 # [B, Cd] (H units)
        hp = jnp.maximum(jnp.moveaxis(hp_ds, 0, 1).mean(1), 1e-12)
        pcnv = (pn_d / hp)[:, None, :]                   # eq-domain

        # Third estimator, per (symbol, carrier): the INSTANTANEOUS
        # residual.  The deterministic ICI occasionally produces single
        # large excursions (>half a decision distance at ZERO noise) whose
        # wrong hard decisions keep |llr| ~6-9; when two of them land on a
        # 4-cycle bit pair of the reference H (the random PEG-ish
        # construction has them), the pair's two shared checks stay
        # satisfied and min-sum can NEVER flip either bit — measured: a
        # payload-deterministic decode failure of 400-byte QAM256 R2/3
        # frames at 80 dB that no LLR scaling fixes, an ARQ livelock.
        # Deflating by the per-sample residual turns exactly the excursion
        # samples into near-erasures the code fills from parity; correct
        # decisions lose nothing (their residual IS the noise, already the
        # nv floor).  Half-weight keeps the deflation from softening
        # genuinely-decodable waterfall-edge bits (measured: thresholds in
        # tests/test_high_order.py unchanged).
        inst = 0.5 * jnp.abs(eq - d) ** 2
        nv_eff = jnp.clip(
            jnp.maximum(jnp.maximum(jnp.maximum(r, pcnv), cnv), inst),
            MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR) \
            * demap_ops.CE_MARGIN.get(mod, 1.0)
        llrs2 = demap_ops.demap(mod, eq.astype(jnp.complex64), nv_eff)
        return state, llrs2.reshape(B, -1)

    llrs = ys[0]
    return state, jnp.moveaxis(llrs, 0, 1).reshape(B, -1)


def num_symbols_for_bits(config: ModemConfig, mod: Modulation, nbits: int) -> int:
    cm = carriers_mod.carrier_map(config)
    per_sym = len(cm.data_idx) * bits_per_symbol(mod)
    return -(-nbits // per_sym)
