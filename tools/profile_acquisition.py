#!/usr/bin/env python
"""Profile chirp acquisition throughput on device.

Reference: tools/profile_acquisition.cpp (463 lines timing the C++ chirp
search).  Measures batched dual-chirp detection (FFT matched filters over
full buffers) in buffers/sec and samples/sec.

Usage: python tools/profile_acquisition.py [--cpu] [--batch 64] [--seconds 4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=4.0,
                    help="audio seconds per buffer")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax
    import jax.numpy as jnp
    from projectultra.sync import chirp as CS
    from projectultra.sim import watterson as W

    cc = CS.ChirpConfig()
    B = args.batch
    T = int(args.seconds * 48000)
    rng = np.random.default_rng(0)
    sig = np.zeros((B, T), np.float32)
    c = CS.generate(cc)
    offs = rng.integers(0, T - len(c) - 1000, B)
    for b, off in enumerate(offs):
        sig[b, off:off + len(c)] = c
    noisy = W.add_noise_active(jax.random.PRNGKey(0),
                               jnp.asarray(sig), 5.0)

    det = CS.detect_dual_chirp(cc, noisy)
    jax.block_until_ready(det)
    found = np.asarray(det["success"])
    err = np.abs(np.asarray(det["up_chirp_start"]) - offs)
    print(f"detection: {found.mean():.0%} found, "
          f"pos err p50={np.percentile(err, 50):.0f} "
          f"p95={np.percentile(err, 95):.0f} samples")

    t0 = time.perf_counter()
    for _ in range(args.iters):
        det = CS.detect_dual_chirp(cc, noisy)
    jax.block_until_ready(det)
    dt = (time.perf_counter() - t0) / args.iters
    print(f"acquisition: {B} x {args.seconds:.0f}s buffers in {dt * 1e3:.1f} ms"
          f" -> {B / dt:.0f} buffers/s, "
          f"{B * T / dt / 1e9:.2f} Gsamples/s searched")
    return 0


if __name__ == "__main__":
    sys.exit(main())
