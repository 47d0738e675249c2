"""NCO / frequency-shift phase ramps, drift-free without float64.

The reference uses an incremental float32 NCO (src/dsp/filters.cpp:228-262).
On the device we avoid both the sequential accumulator and float64 (slow
or emulated on accelerators) with two tricks:

* integer-modular phase for integer frequencies: phase(t) =
  2*pi*((fc * (t mod fs)) mod fs)/fs is EXACT in int32 for fc*fs < 2^31 —
  the modem's 1500 Hz/48 kHz mixer is exactly periodic with period 32;
* split-index phase for traced float frequencies (CFO ramps): with
  t = q*fs + r, frac(f*t/fs) = frac(f*q) + f*r/fs keeps every float32
  intermediate small enough that the phase error stays < 1e-3 rad over
  multi-second buffers.

TX oscillators (static frequency, static length) are precomputed on host in
float64 as complex64 constant tables.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

TWO_PI = np.float32(2.0 * np.pi)


def osc_int(freq_hz: int, sample_rate: int, t) -> jnp.ndarray:
    """exp(+j*2*pi*fc*t/fs) for integer fc, fs and int32 sample indices t.

    Exact: all arithmetic is integer-modular.  Requires fc*fs < 2^31.
    """
    t = jnp.asarray(t, jnp.int32)
    tm = jnp.mod(t, sample_rate)
    num = jnp.mod(freq_hz * tm, sample_rate)
    phase = TWO_PI * num.astype(jnp.float32) / np.float32(sample_rate)
    return jnp.exp(1j * phase).astype(jnp.complex64)


def osc_fixed(freq_hz: float, sample_rate: float, n: int, offset: int = 0) -> np.ndarray:
    """Host-side constant oscillator table (float64 phase, complex64 out)."""
    t = np.arange(offset, offset + n, dtype=np.float64)
    phase = np.mod(2.0 * np.pi * freq_hz * t / sample_rate, 2.0 * np.pi)
    return np.exp(1j * phase).astype(np.complex64)


def osc_traced(freq_hz, sample_rate: int, t) -> jnp.ndarray:
    """exp(+j*2*pi*f*t/fs) for traced (possibly per-batch) float frequency.

    Uses the split-index trick: t = q*fs + r with integer q, r so that
    frac(f*t/fs) = frac(f*q) + f*r/fs never multiplies f by a large number.
    freq_hz broadcasts against t.
    """
    t = jnp.asarray(t, jnp.int32)
    q = (t // sample_rate).astype(jnp.float32)
    r = (t % sample_rate).astype(jnp.float32)
    f = jnp.asarray(freq_hz, jnp.float32)
    cycles = jnp.mod(f * q, 1.0) + f * r / np.float32(sample_rate)
    phase = TWO_PI * jnp.mod(cycles, 1.0)
    return jnp.exp(1j * phase).astype(jnp.complex64)
