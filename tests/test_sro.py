"""Sample-rate-offset robustness gate (tools/test_sro.py at suite scale).

Real TX/RX soundcards run tens of ppm apart; the reference has no SRO test
or compensation anywhere (no resample/ppm/skew under its tests/ or
src/sync).  The full row/ppm matrix lives in the tool; the suite pins the
consumer-soundcard class (|ppm| <= 50) on the default 512 Cox row through
the real streaming engine.
"""

import importlib.util
import os

_TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "test_sro.py")


def _load_tool():
    spec = importlib.util.spec_from_file_location("sro_tool", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sro_50ppm_cox_dqpsk():
    tool = _load_tool()
    from projectultra.config import Modulation, CodeRate
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol.frame_v2 import WaveformMode

    res = tool.run_row(
        "512 COX DQPSK R1/2 @25dB", lambda: ModemEngine(),
        WaveformMode.OFDM_COX, Modulation.DQPSK, CodeRate.R1_2,
        25.0, 200, [50, -50], frames=1)
    for ppm, (n_ok, n) in res.items():
        assert n_ok == n, f"{ppm:+} ppm: {n_ok}/{n} frames decoded"


def test_sro_100ppm_cox_qam16_retry():
    """The round-4 red cell: 512-plan QAM16 at +100 ppm accumulates ~5.5
    samples of end-of-frame drift against the analysis window's ~4-sample
    late-side slack (guard = 4) and corrupted the tail codewords at ANY
    SNR.  The failed-decode clock-skew retry (cox.py: estimate eps from
    the pilot timing track, fractionally resample around the LTS anchor,
    re-demodulate) must recover it — and must report that it fired."""
    tool = _load_tool()
    from projectultra.config import Modulation, CodeRate
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol.frame_v2 import WaveformMode

    engines = []

    def mk():
        e = ModemEngine()
        engines.append(e)
        return e

    res = tool.run_row(
        "512 COX QAM16 R2/3 @25dB", mk,
        WaveformMode.OFDM_COX, Modulation.QAM16, CodeRate.R2_3,
        25.0, 400, [100, -100], frames=1)
    for ppm, (n_ok, n) in res.items():
        assert n_ok == n, f"{ppm:+} ppm: {n_ok}/{n} frames decoded"
    assert any(e.stats.frames_sro_retried > 0 for e in engines)


def test_sro_resampler_passthrough():
    """At 0 ppm the Catmull-Rom resampler must be a near-exact pass-through
    (integer phases): the SRO measurements then isolate clock skew, not
    interpolation error."""
    import numpy as np
    tool = _load_tool()
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, 48000).astype(np.float32)
    y = tool.apply_sro(x, 0)
    n = len(y)
    assert n >= 48000 - 8
    assert np.max(np.abs(y - x[:n])) < 1e-6
