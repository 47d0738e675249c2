#!/usr/bin/env python
"""BER/FER vs SNR curves per (modulation, rate) — the batched version of
the reference's per-point spot checks.

Every (SNR point x frame) pair rides one batch axis, so a full curve of
7 SNR points x 2048 independent noise realizations is a single device
dispatch (~15k full encode+channel+decode pipelines per row).  Writes a
JSON artifact next to the table.

Usage: python tools/ber_curves.py [--cpu] [--frames N] [--json PATH]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=2048,
                    help="frames per SNR point")
    ap.add_argument("--json", default="/tmp/ber_curves.json")
    ap.add_argument("--channel", default="awgn",
                    choices=["awgn", "good", "moderate", "poor", "flutter"])
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 LDPC edge messages (overlay against the "
                         "default f32 run to verify no waterfall shift)")
    args = ap.parse_args()
    if args.bf16:
        os.environ["ULTRA_LDPC_BF16"] = "1"
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    jax.config.update("jax_default_prng_impl", "rbg")
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp
    from projectultra.config import Modulation, CodeRate
    from projectultra.fec import ldpc
    from projectultra.ofdm import pipeline as P
    from projectultra.sim import watterson as W

    F = args.frames
    rows = [
        ("OFDM DQPSK R1/4", Modulation.DQPSK, CodeRate.R1_4,
         [-8.0, -6.0, -4.0, -2.0, 0.0, 2.0, 4.0]),
        ("OFDM DQPSK R1/2", Modulation.DQPSK, CodeRate.R1_2,
         [0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0]),
        ("OFDM DQPSK R2/3", Modulation.DQPSK, CodeRate.R2_3,
         [-2.0, 0.0, 2.0, 4.0, 6.0, 8.0, 10.0]),
        ("OFDM D8PSK R1/2", Modulation.D8PSK, CodeRate.R1_2,
         [2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0]),
    ]

    artifact = {"frames_per_point": F, "channel": args.channel,
                "ldpc_msg_dtype": "bf16" if args.bf16 else "f32", "rows": []}
    total_pipelines = 0
    t_all = time.perf_counter()
    for label, mod, rate, snrs in rows:
        cfg = P.chirp_ofdm_config()
        code = ldpc.get_code(rate)
        n = len(snrs) * F
        rng = np.random.default_rng(42)
        info = jnp.asarray(rng.integers(0, 2, (n, code.k)).astype(np.float32))
        snr_vec = jnp.asarray(np.repeat(np.asarray(snrs, np.float32), F))

        preset = None if args.channel == "awgn" else getattr(W, args.channel)

        @jax.jit
        def run(info, snr_vec, key):
            tx = P.tx_frame(cfg, mod, rate, info)
            if preset is not None:
                tx = W.watterson(jax.random.fold_in(key, 1), tx, preset())
            rx = W.add_noise_active(key, tx, snr_vec)
            out, ok, _ = P.rx_frame(cfg, mod, rate, rx)
            return out, ok

        t0 = time.perf_counter()
        out, ok = run(info, snr_vec, jax.random.PRNGKey(7))
        bits_err = (np.asarray(out) != np.asarray(info, np.uint8)
                    ).reshape(len(snrs), F, -1)
        oks = np.asarray(ok).reshape(len(snrs), F)
        dt = time.perf_counter() - t0
        total_pipelines += n

        ber = bits_err.mean((1, 2))
        fer = 1.0 - oks.mean(1)
        print(f"--- {label} [{args.channel}]  ({n} pipelines in {dt:.2f}s) ---")
        print("SNR:  " + "  ".join(f"{s:6.0f}" for s in snrs))
        print("FER:  " + "  ".join(f"{v:6.4f}" for v in fer))
        print("BER:  " + "  ".join(f"{v:6.4f}" for v in ber))
        print()
        artifact["rows"].append({"label": label, "snrs": snrs,
                                 "fer": fer.tolist(), "ber": ber.tolist()})

    dt_all = time.perf_counter() - t_all
    artifact["total_pipelines"] = total_pipelines
    artifact["wall_seconds"] = round(dt_all, 2)
    with open(args.json, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"{total_pipelines} pipelines in {dt_all:.1f}s "
          f"-> {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
