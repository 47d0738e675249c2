#!/usr/bin/env python
"""Sample-rate-offset (SRO) robustness: decode rate vs TX/RX clock skew.

Real deployments run the TX and RX soundcards on independent crystals that
differ by tens of ppm (consumer cards: 20-100 ppm); the RX stream is then a
fractionally-resampled version of the TX audio, so symbol timing DRIFTS
through the frame (at 100 ppm, 4.8 samples per second of audio) and every
tone is scaled by (1+eps).  The reference has NO test or compensation for
this (its sims share one clock; grep: no resample/ppm/skew anywhere under
/root/reference/tests or src/sync) — this tool measures the rebuild's
tolerance through the REAL streaming path: one ModemEngine, chunked feed,
no position oracle (TESTING_METHODOLOGY anti-cheat rules).

The skew is injected by Catmull-Rom cubic fractional resampling (the signal
band tops out at 2.7 kHz against a 48 kHz rate, ~18x oversampled, so the
interpolation error is far below every row's noise floor — verified at
0 ppm where the resampler is a pure fractional-phase pass-through).

Drift arithmetic per row (worst case, 100 ppm): a ~4 s NVIS QAM256 frame
accumulates ~19 samples of symbol-timing drift — comparable to the 1024-FFT
plan's cyclic prefix margin after the LTS fine-timing backoff — while a
~1.5 s 512-plan frame accumulates ~7.  Pilot plans track the resulting
per-carrier phase ramp with the pilot EMA; the no-pilot NVIS plan leans on
the decision-directed refinement.

Usage: python tools/test_sro.py [--cpu] [--quick] [--rows r1,r2]
           [--ppm 0,20,-20,50,-50,100,-100] [--frames 3]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def apply_sro(audio, ppm):
    """Resample by (1 + ppm*1e-6): RX clock slower/faster than TX.

    Catmull-Rom cubic interpolation at fractional positions
    t_n = n * (1 + eps); ~18x oversampling puts the cubic's interpolation
    error way below -80 dB in the 300-2700 Hz band.
    """
    import numpy as np
    eps = ppm * 1e-6
    n_out = int(len(audio) / (1.0 + eps)) - 4
    t = np.arange(n_out, dtype=np.float64) * (1.0 + eps)
    i = np.floor(t).astype(np.int64)
    f = (t - i).astype(np.float64)
    x = np.pad(audio.astype(np.float64), (1, 3))
    xm1, x0, x1, x2 = x[i], x[i + 1], x[i + 2], x[i + 3]
    # Catmull-Rom basis
    a = -0.5 * xm1 + 1.5 * x0 - 1.5 * x1 + 0.5 * x2
    b = xm1 - 2.5 * x0 + 2.0 * x1 - 0.5 * x2
    c = -0.5 * xm1 + 0.5 * x1
    return (((a * f + b) * f + c) * f + x0).astype(np.float32)


def run_row(label, mk_engine, waveform, mod, rate, snr_db, payload, ppm_list,
            frames, chunk=960, verbose=True, distort=None, unit="ppm"):
    """Streams `frames` random-payload frames through one RX engine per
    variant value in ppm_list, applying `distort(stream, value)` (default:
    apply_sro) before the noise.  Shared harness for the SRO matrix and
    the CFO-ramp tool (tools/test_cfo_ramp.py)."""
    import numpy as np
    from projectultra.protocol import frame_v2 as F

    if distort is None:
        distort = apply_sro

    rng = np.random.default_rng(11)
    tx = mk_engine()
    tx.set_waveform_mode(waveform)
    tx.connect_waveform = waveform
    tx.connected = True
    tx.handshake_complete = True
    tx.data_modulation = mod
    tx.data_code_rate = rate

    # RANDOM payloads (CLAUDE.md: fixed payloads hide payload-dependent
    # corruption at high-order modes).
    payloads = [rng.integers(0, 256, payload).astype(np.uint8).tobytes()
                for _ in range(frames)]
    frame_audio = [tx.transmit(F.DataFrame.make_data(
        "W1AW", "VE3ABC", i, pb).serialize()) for i, pb in enumerate(payloads)]

    results = {}
    for ppm in ppm_list:
        stream_parts = [np.zeros(int(rng.uniform(1.0, 2.0) * 48000),
                                 np.float32)]
        for fa in frame_audio:
            stream_parts.append(fa)
            stream_parts.append(np.zeros(int(rng.uniform(0.5, 1.0) * 48000),
                                         np.float32))
        stream_parts.append(np.zeros(48000, np.float32))
        stream = np.concatenate(stream_parts)
        stream = distort(stream, ppm)
        sig_power = float(np.mean(np.concatenate(frame_audio) ** 2))
        noise = rng.normal(0, np.sqrt(sig_power / 10 ** (snr_db / 10.0)),
                           len(stream)).astype(np.float32)
        stream = stream + noise

        rx = mk_engine()
        rx.set_waveform_mode(waveform)
        rx.connect_waveform = waveform
        rx.connected = True
        rx.handshake_complete = True
        rx.data_modulation = mod
        rx.data_code_rate = rate
        got = []
        rx.on_frame = got.append
        fed = 0
        for i in range(0, len(stream), chunk):
            rx.feed_audio(stream[i:i + chunk])
            fed += chunk
            if fed % 4800 < chunk:
                rx.poll()
        rx.feed_audio(np.zeros(16000, np.float32))
        rx.poll()

        decoded = []
        for fr in got:
            df = F.DataFrame.deserialize(fr.frame_bytes)
            if df:
                decoded.append(bytes(df.payload))
        n_ok = sum(1 for pb in payloads if pb in decoded)
        results[ppm] = (n_ok, frames)
        if verbose:
            print(f"  {label:<34} {ppm:>+6} {unit}  {n_ok}/{frames}")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--rows", default=None)
    ap.add_argument("--ppm", default="0,20,-20,50,-50,100,-100")
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

    rows = {
        "cox_dqpsk": ("512 COX DQPSK R1/2 @25dB", lambda: ModemEngine(),
                      WaveformMode.OFDM_COX, Modulation.DQPSK, CodeRate.R1_2,
                      25.0, 200),
        "cox_qam16": ("512 COX QAM16 R2/3 @25dB", lambda: ModemEngine(),
                      WaveformMode.OFDM_COX, Modulation.QAM16, CodeRate.R2_3,
                      25.0, 400),
        "chirp_dqpsk": ("512 CHIRP DQPSK R1/2 @17dB", lambda: ModemEngine(),
                        WaveformMode.OFDM_CHIRP, Modulation.DQPSK,
                        CodeRate.R1_2, 17.0, 200),
        "mc_dpsk": ("MC-DPSK DQPSK R1/2 @10dB", lambda: ModemEngine(),
                    WaveformMode.MC_DPSK, Modulation.DQPSK, CodeRate.R1_2,
                    10.0, 120),
        "otfs": ("OTFS_EQ QPSK R1/2 @20dB", lambda: ModemEngine(),
                 WaveformMode.OTFS_EQ, Modulation.QPSK, CodeRate.R1_2,
                 20.0, 150),
        # 33 dB wideband, not the reference's "30+": its README SNRs are
        # on the INFLATED pilot scale (reads 10-20 dB above wideband,
        # CLAUDE.md); 432 B matches the throughput row's frame shape.
        "nvis_qam32": ("NVIS QAM32 R3/4 @33dB",
                       lambda: ModemEngine(config=nvis_mode()),
                       WaveformMode.OFDM_COX, Modulation.QAM32, CodeRate.R3_4,
                       33.0, 432),
        "nvis_qam64": ("NVIS QAM64 R3/4 @33dB",
                       lambda: ModemEngine(config=nvis_mode()),
                       WaveformMode.OFDM_COX, Modulation.QAM64, CodeRate.R3_4,
                       33.0, 1500),
        "nvis_qam256": ("NVIS QAM256 R5/6 @42dB",
                        lambda: ModemEngine(config=nvis_mode()),
                        WaveformMode.OFDM_COX, Modulation.QAM256,
                        CodeRate.R5_6, 42.0, 4000),
    }
    sel = (args.rows.split(",") if args.rows
           else ["cox_dqpsk", "cox_qam16", "nvis_qam256"] if args.quick
           else list(rows))
    ppm_list = [int(p) for p in args.ppm.split(",")]

    print(f"{'row':<36} {'ppm':>8} {'decoded'}")
    all_ok = True
    for key in sel:
        label, mk, wf, mod, rate, snr, payload = rows[key]
        res = run_row(label, mk, wf, mod, rate, snr, payload, ppm_list,
                      args.frames)
        # Gate: full decode at |ppm| <= 100 (beyond the consumer-soundcard
        # class; the +100 ppm 512-plan edge is closed by the failed-decode
        # clock-skew resample retry, modem/acquisition/cox.py round 5).
        for ppm, (n_ok, n) in res.items():
            if abs(ppm) <= 100 and n_ok < n:
                all_ok = False
    print("SRO gate (|ppm| <= 100):", "PASS" if all_ok else "FAIL")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
