#!/usr/bin/env python
"""Single-carrier DPSK decode rate vs SNR (AWGN).

Reference: tools/test_dpsk_snr.cpp — R1/4 at very low SNR and R1/2 at low
SNR for the DBPSK/DQPSK/D8PSK presets, with the real Barker-13x3 preamble
search in the loop.  Batched: trials x SNR points ride one batch axis
per (preset, rate) row.

Usage: python tools/test_dpsk_snr.py [--cpu] [--trials N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trials", type=int, default=10)
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp
    from projectultra.config import CodeRate
    from projectultra.fec import ldpc
    from projectultra.ops import ldpc as ldpc_ops
    from projectultra.psk import dpsk as D
    from projectultra.sim import watterson as W

    T = args.trials
    rows = [
        ("DBPSK 31.25bd (robust)", D.robust(), CodeRate.R1_4,
         [-12.0, -11.0, -10.0, -8.0, -5.0]),
        ("DBPSK 62.5bd (low_snr)", D.low_snr(), CodeRate.R1_4,
         [-8.0, -5.0, -3.0, 0.0, 3.0]),
        ("DQPSK 62.5bd (medium)", D.medium(), CodeRate.R1_4,
         [-5.0, -3.0, 0.0, 3.0, 5.0]),
        ("DQPSK 125bd (fast)", D.fast(), CodeRate.R1_2,
         [0.0, 3.0, 5.0, 8.0, 10.0]),
        ("D8PSK 125bd (turbo)", D.turbo(), CodeRate.R1_2,
         [3.0, 5.0, 8.0, 10.0, 13.0]),
    ]

    print(f"=== Single-carrier DPSK vs SNR (AWGN, {T} trials/point, "
          f"preamble search in the loop) ===\n")
    for label, cfg, rate, snrs in rows:
        code = ldpc.get_code(rate)
        rng = np.random.default_rng(9)
        n = len(snrs) * T
        info = rng.integers(0, 2, (n, code.k)).astype(np.float32)
        cw = ldpc_ops.encode(code, jnp.asarray(info))
        pre = D.generate_preamble(cfg)
        data = D.modulate(cfg, cw)
        tx = jnp.concatenate(
            [jnp.broadcast_to(jnp.asarray(pre), (n, len(pre))), data,
             jnp.zeros((n, 4000))], axis=-1)
        snr_vec = jnp.asarray(np.repeat(np.asarray(snrs, np.float32), T))
        noisy = W.add_noise_active(jax.random.PRNGKey(13), tx, snr_vec)

        found, ds, cfo, ipo, prev = D.find_preamble(cfg, noisy)
        start = int(np.asarray(ds)[0])  # aligned batch: shared start
        llrs = D.demodulate_soft(cfg, noisy[:, start:start + data.shape[-1]],
                                 prev, cfo, ipo)
        _, ok, _ = ldpc_ops.decode(code, llrs[:, :648])
        ok = np.asarray(ok) & np.asarray(found)
        rates = ok.reshape(len(snrs), T).mean(-1)
        print(f"--- {label} R{rate.name[1:].replace('_','/')} ---")
        print("SNR:   " + "  ".join(f"{s:5.0f}dB" for s in snrs))
        print("Result:" + "  ".join(f"{r:6.0%}" for r in rates))
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
