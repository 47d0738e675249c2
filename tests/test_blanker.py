"""Impulse-noise blanker (modem/blanker.py) — beyond-reference.

Premise pinned by measurement (docs/PERF.md round-4 blanker section): an
OFDM_COX DQPSK R1/2 frame at 20 dB SNR survives a 30 ms mid-frame crash
to ~+12 dB over frame power raw, collapses at +15/+20 dB; zero-blanking
the crash recovers it at every tested level.  The reference has no
impulse mitigation (tools/test_hf_reality.cpp injects none).

Adversarial rows mirror the excision suite's: the blanker must never
touch a legitimate stream — clean unit streams (zero noise floor), noisy
flat streams, and Watterson fading streams all pass byte-identical with
zero blanked runs.
"""

import numpy as np
import pytest

from projectultra.config import Modulation, CodeRate
from projectultra.modem.blanker import ImpulseBlanker, BLOCK
from projectultra.modem.engine import ModemEngine
from projectultra.protocol import frame_v2 as F
from projectultra.protocol.frame_v2 import WaveformMode


def _make_engine(wf=WaveformMode.OFDM_COX, mod=Modulation.DQPSK,
                 rate=CodeRate.R1_2):
    e = ModemEngine()
    e.set_waveform_mode(wf)
    e.connect_waveform = wf
    e.connected = True
    e.handshake_complete = True
    e.data_modulation = mod
    e.data_code_rate = rate
    return e


def _frame_audio(msg="BLANKER_TEST_" + "x" * 60):
    fb = F.DataFrame.make_data("W1AW", "VE3ABC", 0, msg).serialize()
    return _make_engine().transmit(fb)


def _run_chunks(blanker, x, chunk=960):
    out = [blanker.process(x[i:i + chunk]) for i in range(0, len(x), chunk)]
    return np.concatenate(out)


def test_clean_stream_exact_passthrough():
    """Zero-noise streams (every golden/parity harness) never engage the
    blanker: byte-identical output, no latency."""
    a = _frame_audio()
    x = np.concatenate([np.zeros(48000, np.float32), a,
                        np.zeros(48000, np.float32)])
    x = x[:len(x) // BLOCK * BLOCK]
    b = ImpulseBlanker(enabled=True)
    y = _run_chunks(b, x)
    assert b.blanked_runs == 0
    assert b.held_samples == 0
    np.testing.assert_array_equal(y, x)


def test_noisy_frame_identical_and_unblanked():
    """Flat noisy stream with a frame onset: the onset exceeds the
    threshold by ~28-31 dB for its whole duration (measured) — the
    run-length gate must release it untouched, and the median-transition
    region must not shed false short runs (released-context gate)."""
    rng = np.random.default_rng(0)
    a = _frame_audio()
    x = np.concatenate([np.zeros(96000, np.float32), a,
                        np.zeros(48000, np.float32)])
    sp = float(np.mean(a ** 2))
    x = x + rng.normal(0, np.sqrt(sp / 10 ** 2.5), len(x)).astype(np.float32)
    x = x[:len(x) // BLOCK * BLOCK]
    b = ImpulseBlanker(enabled=True)
    y = _run_chunks(b, x)
    assert b.blanked_runs == 0
    np.testing.assert_array_equal(y, x[:len(y)])
    assert len(x) - len(y) == b.held_samples


def test_fading_stream_unblanked():
    """Watterson fading: envelope ripple + fade recovery must not read as
    impulses (a false blank erases 60 ms of a frame that was surviving
    the fade)."""
    import jax
    from projectultra.sim import watterson as W

    rng = np.random.default_rng(1)
    a = _frame_audio()
    x = np.concatenate([np.zeros(48000, np.float32), a,
                        np.zeros(48000, np.float32)])
    faded = np.asarray(W.watterson(
        jax.random.PRNGKey(2), x[None, :], W.moderate(snr_db=15.0)))[0]
    faded = faded[:len(faded) // BLOCK * BLOCK].astype(np.float32)
    b = ImpulseBlanker(enabled=True)
    y = _run_chunks(b, faded)
    assert b.blanked_runs == 0
    np.testing.assert_array_equal(y, faded[:len(y)])


def test_gap_burst_blanked_noise_untouched():
    """A 30 ms crash in noise-only audio (+23 dB over the floor) is
    erased as ONE run; every sample outside it is bit-identical."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 0.01, 48000 * 4).astype(np.float32)
    at = 48000 * 2 + 96  # block-aligned for a crisp span check
    n = 1440
    x[at:at + n] += rng.normal(0, 0.15, n).astype(np.float32)
    b = ImpulseBlanker(enabled=True)
    y = _run_chunks(b, np.concatenate([x, np.zeros(4800, np.float32)]))
    assert b.blanked_runs == 1
    z = y[at:at + n]
    assert float(np.mean(z ** 2)) < 1e-8  # erased (edge blocks may remain)
    np.testing.assert_array_equal(y[:at - BLOCK], x[:at - BLOCK])
    np.testing.assert_array_equal(y[at + n + 2 * BLOCK:len(x)],
                                  x[at + n + 2 * BLOCK:len(x)])


def test_qam256_papr_spikes_not_blanked():
    """Pinned false-blank class: QAM256 OFDM frames contain genuine
    isolated 1 ms blocks at >+10 dB over their own running median (PAPR
    tail).  Two such blanks corrupted the trapping-payload frame of
    tests/test_high_order.py before the MIN_RUN gate."""
    import jax
    import jax.numpy as jnp
    from projectultra.sim import watterson as W

    e = _make_engine(mod=Modulation.QAM256, rate=CodeRate.R2_3)
    rng = np.random.default_rng(52000 + 37 * 5)
    payload = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
    fb = F.DataFrame.make_data("AA1AA", "BB2BB", 5, payload).serialize()
    audio = e.transmit(fb)
    a = jnp.asarray(np.concatenate(
        [np.zeros(2400, np.float32), audio,
         np.zeros(4000, np.float32)])[None, :])
    key = jax.random.fold_in(jax.random.PRNGKey(77), 1000 * 5 + int(34.0 * 7))
    noisy = np.asarray(W.add_noise_active(key, a, 34.0))[0]
    b = ImpulseBlanker(enabled=True)
    y = np.concatenate([b.process(noisy),
                        b.process(np.zeros(48000, np.float32))])[:len(noisy)]
    assert b.blanked_runs == 0
    np.testing.assert_array_equal(y, noisy)


def test_disabled_is_identity():
    b = ImpulseBlanker(enabled=False)
    x = np.ones(1000, np.float32)
    np.testing.assert_array_equal(b.process(x), x)


def test_midframe_crash_decode_through():
    """Engine-level: a 30 ms crash at +15 dB over frame power mid-frame
    kills the raw decode (pinned) and the blanker recovers it."""
    a = _frame_audio()
    sp = float(np.mean(a ** 2))
    ns = float(np.sqrt(sp / 10 ** 2.0))  # 20 dB SNR

    def trial(blanker_on, seed=0):
        r = np.random.default_rng(seed)
        x = np.concatenate([np.zeros(96000, np.float32), a,
                            np.zeros(48000, np.float32)]).copy()
        x += r.normal(0, ns, len(x)).astype(np.float32)
        mid = 96000 + int(0.55 * len(a))
        x[mid:mid + 1440] += r.normal(
            0, np.sqrt(sp * 10 ** 1.5), 1440).astype(np.float32)
        e = _make_engine()
        e.blanker.enabled = blanker_on
        got = []
        e.on_frame = got.append
        for i in range(0, len(x), 960):
            e.feed_audio(x[i:i + 960])
            if i % 4800 == 0:
                e.poll()
        e.feed_audio(np.zeros(8000, np.float32))
        e.poll()
        texts = [F.DataFrame.deserialize(fr.frame_bytes).payload_as_text()
                 for fr in got if F.DataFrame.deserialize(fr.frame_bytes)]
        return any(t.startswith("BLANKER_TEST") for t in texts), \
            e.blanker.blanked_runs

    ok_raw, _ = trial(False)
    assert not ok_raw  # premise: the crash kills the unblanked decode
    ok, runs = trial(True)
    assert ok and runs == 1
