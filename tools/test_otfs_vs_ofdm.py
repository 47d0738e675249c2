#!/usr/bin/env python
"""OTFS vs OFDM across ITU-R F.1487 Watterson channel conditions.

Reference: tools/test_otfs_vs_ofdm.cpp — decode-success comparison of the
two waveforms per channel condition, QPSK/DQPSK R1/2, N trials each.  Here
the trials are one batch axis (every trial is an independent channel
realization) so each (waveform, condition) cell is a single device program.

Usage: python tools/test_otfs_vs_ofdm.py [--cpu] [--snr DB] [--trials N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--trials", type=int, default=20)
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp
    from projectultra.config import Modulation, CodeRate
    from projectultra.fec import ldpc
    from projectultra.ofdm import pipeline as P
    from projectultra.ops import ldpc as ldpc_ops
    from projectultra.otfs import otfs as O
    from projectultra.sim import watterson as W

    B = args.trials
    snr = args.snr
    rate = CodeRate.R1_2
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(7)
    info = jnp.asarray(rng.integers(0, 2, (B, code.k)).astype(np.float32))
    cw = ldpc_ops.encode(code, info)

    conditions = [("AWGN", None), ("Good", W.good), ("Moderate", W.moderate),
                  ("Poor", W.poor), ("Flutter", W.flutter)]

    ocfg = O.OTFSConfig()
    ocfg_raw = O.OTFSConfig(tf_equalization=False)

    def channel(tx, preset, key):
        if preset is not None:
            tx = W.watterson(key, tx, preset())
        return W.add_noise_active(jax.random.fold_in(key, 1), tx, snr)

    def run_ofdm(mod, preset, key):
        tx = P.tx_frame(P.chirp_ofdm_config(), mod, rate, info)
        rx = channel(tx, preset, key)
        _, ok, _ = P.rx_frame(P.chirp_ofdm_config(), mod, rate, rx)
        return float(np.asarray(ok).mean())

    def run_otfs(cfg, preset, key):
        tx = O.frame_tx(cfg, Modulation.QPSK, cw)
        rx = channel(tx, preset, key)
        llrs = O.demodulate_frame(cfg, Modulation.QPSK, rx)
        _, ok, _ = ldpc_ops.decode(code, llrs[:, :code.n])
        return float(np.asarray(ok).mean())

    print(f"OTFS vs OFDM — ITU-R F.1487 comparison  (SNR {snr:.0f} dB, "
          f"{B} trials/cell, aligned decode)\n")
    print(f"{'Channel':<10} {'OFDM-DQPSK':>11} {'OTFS-EQ':>9} {'OTFS-RAW':>9}"
          f"  winner")
    wins = {"OFDM": 0, "OTFS": 0, "TIE": 0}
    for i, (name, preset) in enumerate(conditions):
        key = jax.random.PRNGKey(100 + i)
        ofdm = run_ofdm(Modulation.DQPSK, preset, key)
        otfs_eq = run_otfs(ocfg, preset, key)
        otfs_raw = run_otfs(ocfg_raw, preset, key)
        best_otfs = max(otfs_eq, otfs_raw)
        if best_otfs > ofdm + 0.05:
            winner = "OTFS"
        elif ofdm > best_otfs + 0.05:
            winner = "OFDM"
        else:
            winner = "TIE"
        wins[winner] += 1
        print(f"{name:<10} {ofdm:>10.0%} {otfs_eq:>9.0%} {otfs_raw:>9.0%}"
              f"  {winner}")
    print(f"\nOFDM wins: {wins['OFDM']}  OTFS wins: {wins['OTFS']} "
          f" ties: {wins['TIE']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
