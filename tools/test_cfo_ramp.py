#!/usr/bin/env python
"""Doppler-ramp robustness: decode rate vs TIME-VARYING CFO (Hz/s).

The regression matrix and every reference test apply a STATIC CFO; real
ionospheric paths drift — mid-latitude NVIS ~0.01-0.1 Hz/s, disturbed /
trans-auroral paths several times that.  The acquisition stage estimates
one CFO per frame, so a ramp leaves a residual that GROWS through the
frame: rate * frame_seconds Hz by the last symbol (a 4 s NVIS frame at
0.2 Hz/s ends 0.8 Hz off; a ~15 s MC-DPSK robust frame ends 3+ Hz off).
What tracks it: the dual DD PLL (coherent no-pilot), the pilot EMA
(pilot plans), per-symbol differential detection (DPSK family).

Injection: multiply the analytic stream by exp(j*2*pi*integral of
rate*t) — a pure frequency ramp starting at 0 Hz, applied to the WHOLE
stream (preamble included) before noise, through the same engine-level,
no-oracle harness as tools/test_sro.py.

Usage: python tools/test_cfo_ramp.py [--cpu] [--rows r1,r2]
           [--rates 0,0.1,-0.1,0.2,-0.2,0.5] [--frames 3]
"""

import argparse
import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

_SRO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_sro.py")


def _sro_tool():
    spec = importlib.util.spec_from_file_location("sro_tool", _SRO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def apply_cfo_ramp(audio, rate_hz_per_s, fs=48000.0):
    """Frequency-shift the real passband by f(t) = rate * t Hz."""
    import numpy as np
    import scipy.signal as sig
    if rate_hz_per_s == 0:
        return audio
    n = len(audio)
    t = np.arange(n, dtype=np.float64) / fs
    phase = 2.0 * np.pi * 0.5 * rate_hz_per_s * t * t  # integral of rate*t
    z = sig.hilbert(audio.astype(np.float64))
    return np.real(z * np.exp(1j * phase)).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rows", default="cox_dqpsk,cox_qam16,mc_dpsk,"
                                      "nvis_qam64,nvis_qam256")
    ap.add_argument("--rates", default="0,0.1,-0.1,0.2,-0.2,0.5")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from projectultra.config import (ModemConfig, Modulation, CodeRate,
                                         nvis_mode)
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol.frame_v2 import WaveformMode

    tool = _sro_tool()
    rows = {
        "cox_dqpsk": ("512 COX DQPSK R1/2 @25dB", lambda: ModemEngine(),
                      WaveformMode.OFDM_COX, Modulation.DQPSK, CodeRate.R1_2,
                      25.0, 200),
        "cox_qam16": ("512 COX QAM16 R2/3 @25dB", lambda: ModemEngine(),
                      WaveformMode.OFDM_COX, Modulation.QAM16, CodeRate.R2_3,
                      25.0, 400),
        "mc_dpsk": ("MC-DPSK DQPSK R1/2 @10dB", lambda: ModemEngine(),
                    WaveformMode.MC_DPSK, Modulation.DQPSK, CodeRate.R1_2,
                    10.0, 120),
        "nvis_qam64": ("NVIS QAM64 R3/4 @33dB",
                       lambda: ModemEngine(config=nvis_mode()),
                       WaveformMode.OFDM_COX, Modulation.QAM64, CodeRate.R3_4,
                       33.0, 1500),
        "nvis_qam256": ("NVIS QAM256 R5/6 @42dB",
                        lambda: ModemEngine(config=nvis_mode()),
                        WaveformMode.OFDM_COX, Modulation.QAM256,
                        CodeRate.R5_6, 42.0, 4000),
    }
    rates = [float(r) for r in args.rates.split(",")]

    print(f"{'row':<36} {'Hz/s':>10} {'decoded'}")
    all_ok = True
    for key in args.rows.split(","):
        label, mk, wf, mod, rate, snr, payload = rows[key]
        res = tool.run_row(label, mk, wf, mod, rate, snr, payload, rates,
                           args.frames, distort=apply_cfo_ramp, unit="Hz/s")
        # Gate: full decode at |rate| <= 0.2 Hz/s (disturbed-path class).
        for r, (n_ok, n) in res.items():
            if abs(r) <= 0.2 and n_ok < n:
                all_ok = False
    print("CFO-ramp gate (|rate| <= 0.2 Hz/s):", "PASS" if all_ok else "FAIL")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
