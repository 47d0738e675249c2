#!/usr/bin/env python
"""Measure the frame-SNR estimator scales against TRUE wideband SNR.

The reference's frame/pilot SNR estimates (MC-DPSK training, OFDM pilots,
DPSK preamble) read 10-20 dB ABOVE the true wideband channel SNR
(types.hpp's own mode-table scale; CLAUDE.md "SNR scales").  This tool drives the
FULL engine TX->channel->RX path per waveform over a grid of true SNRs and
prints, per (waveform, channel) pair: the legacy estimator readings (with
a least-squares fit est = a*true + b documenting the inflation), and the
round-3 WIDEBAND estimate (ModemEngine._wideband_snr_db) that the
calibrated_snr negotiation mode consumes — the wideband column tracking
`true` within ~1 dB is the estimator's acceptance evidence.

Usage: python tools/calibrate_snr.py [--trials N] [--gpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (default: CPU)")
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.gpu:
        backend.require_gpu()
    else:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol import frame_v2 as F
    from projectultra.protocol.frame_v2 import WaveformMode
    from projectultra.sim import watterson as W

    def run_point(wf, chan, true_snr, trial):
        from projectultra.config import CodeRate
        tx, rx = ModemEngine(), ModemEngine()
        for m in (tx, rx):
            m.set_waveform_mode(wf)
            m.connect_waveform = wf
            # OFDM_COX only carries frames as the CONNECTED data waveform
            # (4-way TX priority, modem_engine.cpp:372-397).
            m.connected = True
            m.handshake_complete = True
            m.data_code_rate = CodeRate.R1_4
        frame = F.ControlFrame.make_ack("AA1AA", "BB2BB", trial).serialize()
        audio = tx.transmit(frame)
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        key = jax.random.fold_in(jax.random.PRNGKey(17),
                                 1000 * trial + int(true_snr * 7) + hash(wf) % 97)
        if chan == "awgn":
            noisy = W.add_noise_active(key, a, true_snr)
        else:
            noisy = W.watterson(key, a, W.PRESETS["moderate"](true_snr))
        got = []
        rx.on_frame = got.append
        rx.feed_audio(np.asarray(noisy)[0])
        rx.poll()
        if not got:
            return None
        return got[0].snr_db, got[0].wideband_snr_db

    waveforms = [WaveformMode.MC_DPSK, WaveformMode.OFDM_COX,
                 WaveformMode.DPSK]
    grid = [0.0, 4.0, 8.0, 12.0, 16.0, 20.0, 24.0]
    fits = {}
    for wf in waveforms:
        for chan in ("awgn", "fade"):
            xs, ys = [], []
            print(f"\n=== {wf.name} / {chan} ===")
            for s in grid:
                vals = [v for t in range(args.trials)
                        if (v := run_point(wf, chan, s, t)) is not None]
                if vals:
                    est = [v[0] for v in vals]
                    wb = [v[1] for v in vals]
                    m = float(np.mean(est))
                    print(f"  true {s:5.1f} dB -> est {m:6.2f} dB "
                          f"(n={len(vals)}, sd={np.std(est):.2f})  "
                          f"wideband {np.mean(wb):6.2f} dB "
                          f"(sd={np.std(wb):.2f})")
                    xs.extend([s] * len(vals))
                    ys.extend(est)
                else:
                    print(f"  true {s:5.1f} dB -> no decode")
            if len(set(xs)) >= 3:
                A = np.stack([np.asarray(xs), np.ones(len(xs))], 1)
                coef, *_ = np.linalg.lstsq(A, np.asarray(ys), rcond=None)
                fits[(wf.name, chan)] = (float(coef[0]), float(coef[1]))
                print(f"  fit: est = {coef[0]:.3f} * true + {coef[1]:.2f}")

    print("\n=== legacy-estimator inflation fits (est = a*true + b) ===")
    for k, (a, b) in fits.items():
        print(f"  {k}: slope={a:.3f} offset={b:.2f}")


if __name__ == "__main__":
    main()
