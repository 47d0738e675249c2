"""Watterson / ITU-R F.1487 HF channel simulator, batched on device.

Reference: src/sim/hf_channel.hpp and the test-harness channel helpers in
tools/test_iwaveform.cpp:42-112.  The per-sample C++ loops become:

* Rayleigh tap fading: the AR(1) recurrence f[n] = (1-a) f[n-1] + a w[n]
  (IIR-lowpass-shaped Gaussian Doppler spectrum) is evaluated with
  ``jax.lax.associative_scan`` — O(log T) depth instead of a T-step loop,
  which is the parallel way to run linear recurrences;
* multipath: a static ``jnp.roll``-free delay via padding/shifting;
* AWGN: noise std from the input RMS (active samples only for the harness
  variant, INV-TEST-001 / docs/TESTING_METHODOLOGY.md:200-230);
* CFO: FFT-Hilbert single-sideband shift of the whole buffer
  (test_iwaveform.cpp:67-112, INV-CFO-003).

Statistical parity, not per-sample RNG parity: the reference draws from
std::normal_distribution(mt19937); we use jax.random.  BER/FER curves are
the parity gate (SURVEY.md §7 hard part #3).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import mixer as mixer_ops


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """(hf_channel.hpp:37-67)"""
    snr_db: float = 15.0
    delay_spread_ms: float = 2.0
    doppler_spread_hz: float = 1.0
    cfo_hz: float = 0.0
    path1_gain: float = 0.707
    path2_gain: float = 0.707
    sample_rate: int = 48000
    fading_enabled: bool = True
    multipath_enabled: bool = True
    noise_enabled: bool = True
    cfo_enabled: bool = True


# ITU-R F.1487 presets (hf_channel.hpp:303-492).
def awgn(snr_db: float) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, fading_enabled=False,
                         multipath_enabled=False, cfo_enabled=False)


def good(snr_db: float = 25.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.5, doppler_spread_hz=0.1)


def moderate(snr_db: float = 15.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=1.0, doppler_spread_hz=0.5)


def poor(snr_db: float = 10.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=2.0, doppler_spread_hz=1.0)


def flutter(snr_db: float = 15.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.5, doppler_spread_hz=10.0)


PRESETS = {"awgn": awgn, "good": good, "moderate": moderate,
           "poor": poor, "flutter": flutter}


# The reference's PRIMARY harness overrides the hf_channel.hpp presets with
# its own channel parameters (test_iwaveform.cpp:530-555): good = faster
# fading with asymmetric 0.9/0.4 paths, poor = ECHO-DOMINANT 0.6/0.8 paths.
# The regression-matrix pass thresholds were derived on THESE channels, so
# the sweep harness must use them — the symmetric presets above are the
# GUI/simulator channels.
def harness_good(snr_db: float) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.5,
                         doppler_spread_hz=0.2, path1_gain=0.9,
                         path2_gain=0.4, cfo_enabled=False)


def harness_moderate(snr_db: float) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=1.0,
                         doppler_spread_hz=0.5, cfo_enabled=False)


def harness_poor(snr_db: float) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=2.0,
                         doppler_spread_hz=1.0, path1_gain=0.6,
                         path2_gain=0.8, cfo_enabled=False)


HARNESS_PRESETS = {"awgn": awgn, "good": harness_good,
                   "moderate": harness_moderate, "poor": harness_poor,
                   "flutter": flutter}


def _ar1_scan(a: float, x: jnp.ndarray, y0) -> jnp.ndarray:
    """y[n] = (1-a) * y[n-1] + a * x[n] with y[-1] = y0, along the last axis,
    via associative_scan over affine maps (A, b) -> y = A*y_prev + b."""
    T = x.shape[-1]
    A = jnp.full(x.shape, 1.0 - a, x.real.dtype).astype(x.dtype)
    b = a * x
    # Fold the initial condition into the first step.
    b = b.at[..., 0].add((1.0 - a) * y0)
    A = A.at[..., 0].set(0.0)

    def combine(l, r):
        Al, bl = l
        Ar, br = r
        return Al * Ar, Ar * bl + br

    _, y = jax.lax.associative_scan(combine, (A, b), axis=-1)
    return y


def rayleigh_taps(key, cfg: ChannelConfig, shape: tuple, T: int) -> jnp.ndarray:
    """Complex AR(1)-filtered Gaussian fading, unit mean power
    (hf_channel.hpp:258-275): input std per component sqrt(1/alpha)."""
    alpha = 1.0 - np.exp(-2.0 * np.pi * cfg.doppler_spread_hz / cfg.sample_rate)
    kr, ki = jax.random.split(key)
    scale = np.sqrt(1.0 / alpha)
    noise = (scale * jax.random.normal(kr, (*shape, T))
             + 1j * scale * jax.random.normal(ki, (*shape, T))).astype(jnp.complex64)
    return _ar1_scan(alpha, noise, jnp.complex64(1.0 + 0j))


@functools.partial(jax.jit, static_argnames=("sample_rate",))
def apply_cfo_hilbert(samples: jnp.ndarray, cfo_hz, sample_rate: float = 48000.0
                      ) -> jnp.ndarray:
    """Test-harness CFO (test_iwaveform.cpp:67-112): FFT -> analytic signal
    (double positive freqs, zero negative) -> rotate by exp(j*2*pi*cfo*t/fs)
    -> real part.  Batched over leading axes; cfo_hz may be per-frame."""
    T = samples.shape[-1]
    n_fft = 1 << (T - 1).bit_length()
    x = jnp.fft.fft(samples.astype(jnp.complex64), n=n_fft, axis=-1)
    mult = np.ones(n_fft, np.float32)
    mult[1:n_fft // 2] = 2.0
    mult[n_fft // 2 + 1:] = 0.0
    analytic = jnp.fft.ifft(x * jnp.asarray(mult), axis=-1)[..., :T]
    cfo = jnp.asarray(cfo_hz, jnp.float32)
    rot = mixer_ops.osc_traced(cfo[..., None], int(sample_rate), jnp.arange(T))
    out = (analytic * rot).real.astype(jnp.float32)
    active = jnp.abs(cfo)[..., None] > 0.001
    return jnp.where(active, out, samples)


@jax.jit
def add_noise_active(key, samples: jnp.ndarray, snr_db) -> jnp.ndarray:
    """Harness AWGN (test_iwaveform.cpp:42-63): signal power measured over
    active samples only (|s| > 1e-6)."""
    active = jnp.abs(samples) > 1e-6
    power = jnp.where(active, samples * samples, 0.0).sum(-1) / jnp.maximum(
        active.sum(-1), 1)
    snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)
    noise_std = jnp.sqrt(power / snr_lin)
    noise = jax.random.normal(key, samples.shape, jnp.float32)
    return samples + noise_std[..., None] * noise


@functools.partial(jax.jit, static_argnames=("cfg",))
def watterson(key, samples: jnp.ndarray, cfg: ChannelConfig) -> jnp.ndarray:
    """WattersonChannel::process for a [B, T] batch (hf_channel.hpp:108-168).

    Fading magnitude (Rayleigh envelope) applied to the real passband signal;
    two equal-power taps with the second delayed by delay_spread_ms; AWGN
    scaled to the whole-buffer input RMS.
    """
    B, T = samples.shape
    k_fade, k_noise, k_cfo = jax.random.split(key, 3)
    out = jnp.zeros_like(samples)

    delay = int(cfg.delay_spread_ms * cfg.sample_rate / 1000.0)

    if cfg.multipath_enabled and delay > 0:
        if cfg.fading_enabled:
            taps = rayleigh_taps(k_fade, cfg, (B, 2), T)
            h1 = jnp.abs(taps[:, 0])
            h2 = jnp.abs(taps[:, 1])
        else:
            h1 = h2 = jnp.ones((B, T), jnp.float32)
        delayed = jnp.pad(samples, ((0, 0), (delay + 1, 0)))[:, :T]
        out = samples * cfg.path1_gain * h1 + delayed * cfg.path2_gain * h2
    else:
        if cfg.fading_enabled:
            h = jnp.abs(rayleigh_taps(k_fade, cfg, (B, 1), T)[:, 0])
        else:
            h = jnp.ones((B, T), jnp.float32)
        out = samples * h

    if cfg.noise_enabled:
        rms = jnp.sqrt((samples * samples).mean(-1))
        noise_std = rms * 10.0 ** (-cfg.snr_db / 20.0)
        out = out + noise_std[:, None] * jax.random.normal(k_noise, out.shape)

    if cfg.cfo_enabled and abs(cfg.cfo_hz) > 0.001:
        out = apply_cfo_hilbert(out, jnp.full((B,), cfg.cfo_hz))

    return out.astype(jnp.float32)
