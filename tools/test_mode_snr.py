#!/usr/bin/env python
"""OFDM D8PSK vs DQPSK decode rate across the full SNR range (AWGN).

Reference: tools/test_mode_snr.cpp — decode % per (modulation, rate, SNR)
and the minimum SNR reaching 90%+.  Batched: all trials AND all SNR
points batch together — each (mod, rate) row is ONE device program over a
[n_snr * trials] batch.

Usage: python tools/test_mode_snr.py [--cpu] [--trials N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
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
    from projectultra.sim import watterson as W

    T = args.trials
    rows = [
        ("D8PSK R1/2", Modulation.D8PSK, CodeRate.R1_2,
         [15.0, 17.0, 20.0, 23.0, 25.0, 28.0, 30.0]),
        ("D8PSK R2/3", Modulation.D8PSK, CodeRate.R2_3,
         [20.0, 23.0, 25.0, 28.0, 30.0, 33.0, 35.0]),
        ("DQPSK R1/2", Modulation.DQPSK, CodeRate.R1_2,
         [15.0, 17.0, 20.0, 23.0, 25.0, 28.0, 30.0]),
        ("DQPSK R2/3", Modulation.DQPSK, CodeRate.R2_3,
         [20.0, 23.0, 25.0, 28.0, 30.0, 33.0, 35.0]),
    ]

    print("=== OFDM D8PSK vs DQPSK — full SNR range (AWGN) ===\n")
    summary = []
    for label, mod, rate, snrs in rows:
        cfg = P.chirp_ofdm_config()
        code = ldpc.get_code(rate)
        rng = np.random.default_rng(5)
        n = len(snrs) * T
        info = jnp.asarray(rng.integers(0, 2, (n, code.k)).astype(np.float32))
        snr_vec = jnp.asarray(np.repeat(np.asarray(snrs, np.float32), T))

        tx = P.tx_frame(cfg, mod, rate, info)
        rx = W.add_noise_active(jax.random.PRNGKey(11), tx, snr_vec)
        _, ok, _ = P.rx_frame(cfg, mod, rate, rx)
        rates = np.asarray(ok).reshape(len(snrs), T).mean(-1)

        print(f"--- {label} ---")
        print("SNR:   " + "  ".join(f"{s:4.0f}dB" for s in snrs))
        print("Result:" + "  ".join(f"{r:5.0%}" for r in rates))
        print()
        min90 = next((s for s, r in zip(snrs, rates) if r >= 0.9), None)
        bps = cfg.theoretical_throughput(mod, rate)
        summary.append((label, bps, min90))

    print("=== Summary ===")
    print(f"{'Mode':<12} {'Theory bps':>10}  Min SNR for 90%+")
    for label, bps, min90 in summary:
        print(f"{label:<12} {bps:>10.0f}  "
              f"{('%.0f dB' % min90) if min90 is not None else '>range'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
