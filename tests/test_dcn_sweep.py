"""Multi-host DCN sweep parity: 2 processes x 4 devices == 1 x 8.

Drives tools/dcn_sweep.py (launcher spawns two jax.distributed-coordinated
worker processes; cross-host reductions ride gloo/TCP)
and requires bit-identical acquisition-sweep counts against the
single-process reference.  SURVEY §2.6 "DCN only for multi-host sweep
scaling".
"""

import os
import subprocess
import sys


def test_dcn_two_process_sweep_matches_single():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "dcn_sweep.py"),
         "--frames", "8"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "RESULT: PASS" in r.stdout
