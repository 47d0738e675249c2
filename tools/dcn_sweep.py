#!/usr/bin/env python
"""Multi-host DCN sweep dryrun: 2 processes x 4 virtual CPU devices.

Launcher (no --process-id): computes the single-process reference counts
(1 x 8 devices), then spawns two coordinated worker processes (4 devices
each) running the SAME global program over a 2-host mesh — cross-host
reductions ride gloo/TCP here — and asserts the counts
are identical.  SURVEY §2.6 "DCN only for multi-host sweep scaling".

Usage:
  python tools/dcn_sweep.py [--frames 16] [--snr 5]           # launcher
  python tools/dcn_sweep.py --process-id N --num-processes M \
      --coordinator 127.0.0.1:PORT                            # worker
"""

import argparse
import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def init_cpu(n_devices: int):
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n_devices)
    return jax


def worker(args):
    jax = init_cpu(4)
    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id)
    assert len(jax.devices()) == 4 * args.num_processes, jax.devices()
    from projectultra.parallel import dcn
    counts = dcn.acq_sweep_counts(B=args.frames, snr_db=args.snr)
    print("WORKER_RESULT " + json.dumps(counts), flush=True)
    jax.distributed.shutdown()
    return 0


def launcher(args):
    jax = init_cpu(8)
    from projectultra.parallel import dcn
    ref = dcn.acq_sweep_counts(B=args.frames, snr_db=args.snr)
    print(f"single-process 1x8 reference: {ref}")
    assert ref["decoded"] == args.frames, \
        f"reference sweep must fully decode, got {ref}"

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, os.path.abspath(__file__),
            "--frames", str(args.frames), "--snr", str(args.snr),
            "--num-processes", "2", "--coordinator", f"127.0.0.1:{port}"]
    env = dict(os.environ)
    procs = [subprocess.Popen(base + ["--process-id", str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, env=env, text=True)
             for i in range(2)]
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=args.timeout)
        assert p.returncode == 0, f"worker failed rc={p.returncode}\n{out}"
        for line in out.splitlines():
            if line.startswith("WORKER_RESULT "):
                results.append(json.loads(line.split(" ", 1)[1]))
    assert len(results) == 2, results
    print(f"2-process 2x4 workers:        {results[0]} / {results[1]}")
    ok = results[0] == ref and results[1] == ref
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--snr", type=float, default=5.0)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    if args.process_id is not None:
        return worker(args)
    return launcher(args)


if __name__ == "__main__":
    sys.exit(main())
