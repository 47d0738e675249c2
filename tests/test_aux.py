"""Auxiliary subsystem tests: logging, metrics, settings, observability."""

import io

import numpy as np

from projectultra.utils import logging as L
from projectultra.utils.metrics import ModemStats, BatchMetrics, stage_timer
from projectultra.utils.settings import AppSettings
from projectultra.utils import observability as obs


def test_logging_levels_and_categories():
    buf = io.StringIO()
    L.redirect(buf)
    L.set_level("INFO")
    L.info("DEMOD", "hello %d", 42)
    L.debug("DEMOD", "not shown")
    L.enable_category("SYNC", False)
    L.info("SYNC", "gated")
    L.enable_category("SYNC", True)
    out = buf.getvalue()
    assert "hello 42" in out and "not shown" not in out and "gated" not in out
    assert "[INFO " in out
    L.redirect(__import__("sys").stderr)
    L.set_level("WARN")


def test_metrics():
    m = BatchMetrics(frames=10, decoded=9, bit_errors=5, total_bits=6480)
    assert abs(m.fer - 0.1) < 1e-9
    assert abs(m.ber - 5 / 6480) < 1e-12
    times = {}
    with stage_timer("demod", times):
        pass
    assert "demod" in times
    s = ModemStats()
    assert s.frames_sent == 0


def test_settings_roundtrip(tmp_path):
    path = str(tmp_path / "settings.ini")
    s = AppSettings(callsign="W1AW", auto_accept=False,
                    forced_waveform=0x05, log_level="DEBUG")
    s.save(path)
    t = AppSettings.load(path)
    assert t.callsign == "W1AW"
    assert t.auto_accept is False
    assert t.forced_waveform == 0x05
    assert t.forced_modulation == 0xFF
    assert t.log_level == "DEBUG"


def test_waterfall_and_constellation():
    t = np.arange(48000) / 48000.0
    sig = np.sin(2 * np.pi * 1500.0 * t).astype(np.float32)
    power, freqs = obs.waterfall(sig)
    assert power.shape[1] == 1025
    # Peak bin at ~1500 Hz in every line.
    peak = freqs[np.argmax(power, axis=1)]
    assert np.abs(peak - 1500.0).max() < 50

    pts = obs.constellation(np.exp(1j * np.linspace(0, 6, 1000)))
    assert pts.shape == (500, 2)
    assert np.abs(np.hypot(pts[:, 0], pts[:, 1]) - 1).max() < 1e-5


def test_waterfall_batch_and_short_inputs():
    """[B, T] input flattens in time order (no silent row drop) and
    shorter-than-fft input zero-pads to one valid line (review fix)."""
    from projectultra.utils.observability import waterfall
    x = np.random.default_rng(0).normal(0, 1, (3, 4096)).astype(np.float32)
    p2, _ = waterfall(x, fft_size=2048)
    pflat, _ = waterfall(x.reshape(-1), fft_size=2048)
    assert p2.shape == pflat.shape  # batch rows all contribute
    np.testing.assert_allclose(p2, pflat, rtol=1e-5)
    p1, freqs = waterfall(np.ones(500, np.float32), fft_size=2048)
    assert p1.shape == (1, 1025) and np.isfinite(p1).all()


def test_webui_scripted_session():
    """Browser front-end (tools/webui.py): scripted end-to-end session
    through the HTTP API — connect, waterfall rows present, chat echo from
    the virtual remote, constellation points, disconnect (the GUI rows'
    closing evidence; SURVEY §2.5 App/widgets)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "webui.py"),
         "--cpu", "--script", "--port", "8761"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=900)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    assert "PASS" in r.stdout
