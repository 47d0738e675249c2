#!/usr/bin/env python
"""Measure decode envelopes for the calibrated negotiation tables.

For each (modulation, rate) data mode over OFDM_COX — plus the MC_DPSK and
MFSK floors — run connected-engine DATA-frame loopbacks across a grid of
TRUE wideband SNRs on AWGN and moderate-fading Watterson channels and print
decode rates.  The calibrated thresholds in
protocol/connection.py:recommend_data_mode_calibrated and
modem/adaptive.py:CalibratedAdaptiveController.TABLE are pinned from these
envelopes (lowest SNR with reliable decode on BOTH channels + ~2 dB
margin).  Rerun this tool to re-derive them.

Usage: python tools/calibrate_mode_table.py [--trials N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--only", default="",
                    help="substring filter on 'WAVEFORM MOD RATE' row names")
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from projectultra.config import Modulation, CodeRate
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol import frame_v2 as F
    from projectultra.protocol.frame_v2 import WaveformMode
    from projectultra.sim import watterson as W

    def run_point(wf, mod, rate, chan, true_snr, trial):
        tx, rx = ModemEngine(), ModemEngine()
        for m in (tx, rx):
            m.set_waveform_mode(wf)
            m.connect_waveform = wf
            m.connected = True
            m.handshake_complete = True
            m.data_modulation = mod
            m.data_code_rate = rate
        # RANDOM payloads: a fixed payload hid a 20% QAM64 R3/4 silent-
        # corruption rate (parity-free bits on the ICI floor) — and
        # calibrate LONG frames too when touching high-order rows
        # (tests/test_high_order._long_loopback): 400-byte frames expose
        # ~5x the parity-free bits of these 80-byte points.
        prng = np.random.default_rng(91000 + 37 * trial)
        payload = bytes(prng.integers(0, 256, 80, dtype=np.uint8))
        frame = F.DataFrame.make_data("AA1AA", "BB2BB", trial,
                                      payload).serialize()
        audio = tx.transmit(frame)
        a = jnp.asarray(np.concatenate(
            [np.zeros(2400, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        key = jax.random.fold_in(
            jax.random.PRNGKey(29),
            10000 * trial + int(true_snr * 7) + (hash((wf, mod, rate)) % 997))
        if chan == "awgn":
            noisy = W.add_noise_active(key, a, true_snr)
        else:
            noisy = W.watterson(key, a, W.PRESETS["moderate"](true_snr))
        got = []
        rx.on_frame = got.append
        rx.feed_audio(np.asarray(noisy)[0])
        rx.poll()
        return bool(got) and got[0].frame_bytes == frame

    rows = [
        (WaveformMode.OFDM_COX, Modulation.DBPSK, CodeRate.R1_4,
         [4, 6, 8, 10, 12]),
        (WaveformMode.OFDM_COX, Modulation.DQPSK, CodeRate.R1_4,
         [6, 8, 10, 12, 14]),
        (WaveformMode.OFDM_COX, Modulation.DQPSK, CodeRate.R1_2,
         [9, 11, 13, 15, 17]),
        (WaveformMode.OFDM_COX, Modulation.DQPSK, CodeRate.R2_3,
         [13, 15, 17, 19, 21]),
        (WaveformMode.OFDM_COX, Modulation.QAM16, CodeRate.R2_3,
         [17, 19, 21, 23, 25]),
        (WaveformMode.OFDM_COX, Modulation.QAM16, CodeRate.R3_4,
         [20, 22, 24, 26, 28]),
        # Beyond-reference high-order modes (engine 512-FFT pilot config;
        # the fade rows COLLAPSE at all SNRs — negotiation only routes
        # these on a PROVEN-FLAT fade reading, see
        # CalibratedAdaptiveController.HIGH_TABLE).  R5/6 rows are absent
        # by design: the reference H construction leaves info bits 217-539
        # parity-free at R5/6 (325-485 at R3/4 — which survives because
        # QAM64 R3/4's raw BER at its 24 dB envelope is already ~0), so an
        # unprotected bit on the 512-plan's DC-adjacent ICI-floor carriers
        # flips with cw_ok still True at ANY SNR (measured 28-36 dB:
        # always the same bit).
        (WaveformMode.OFDM_COX, Modulation.QAM64, CodeRate.R2_3,
         [22, 24, 26, 28, 30]),
        (WaveformMode.OFDM_COX, Modulation.QAM64, CodeRate.R3_4,
         [24, 26, 28, 30, 32]),
        (WaveformMode.OFDM_COX, Modulation.QAM256, CodeRate.R2_3,
         [28, 30, 32, 34, 36]),
        (WaveformMode.MC_DPSK, Modulation.DQPSK, CodeRate.R1_4,
         [-2, 0, 2, 4, 6, 8]),
        (WaveformMode.DPSK, Modulation.DQPSK, CodeRate.R1_4,
         [-6, -4, -2, 0, 2]),
    ]
    for wf, mod, rate, grid in rows:
        if args.only and args.only not in f"{wf.name} {mod.name} {rate.name}":
            continue
        for chan in ("awgn", "fade"):
            line = [f"{wf.name:9s} {mod.name:6s} {rate.name:5s} {chan:5s}:"]
            for s in grid:
                oks = [run_point(wf, mod, rate, chan, float(s), t)
                       for t in range(args.trials)]
                line.append(f"{s:+3d}dB={sum(oks)}/{len(oks)}")
            print("  ".join(line), flush=True)


if __name__ == "__main__":
    main()
