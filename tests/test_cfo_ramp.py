"""Doppler-ramp robustness gate (tools/test_cfo_ramp.py at suite scale).

Every reference test applies a STATIC CFO; real ionospheric paths drift
(mid-latitude ~0.01-0.1 Hz/s, disturbed paths more).  The full row/rate
matrix lives in the tool; the suite pins the disturbed-path class
(|0.2| Hz/s) on the default 512 Cox row through the real streaming engine.
"""

import importlib.util
import os

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tools")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cfo_ramp_0p2hzps_cox_dqpsk():
    sro = _load("test_sro")
    ramp = _load("test_cfo_ramp")
    from projectultra.config import Modulation, CodeRate
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol.frame_v2 import WaveformMode

    res = sro.run_row(
        "512 COX DQPSK R1/2 @25dB", lambda: ModemEngine(),
        WaveformMode.OFDM_COX, Modulation.DQPSK, CodeRate.R1_2,
        25.0, 200, [0.2, -0.2], frames=1,
        distort=ramp.apply_cfo_ramp, unit="Hz/s")
    for r, (n_ok, n) in res.items():
        assert n_ok == n, f"{r:+} Hz/s: {n_ok}/{n} frames decoded"
