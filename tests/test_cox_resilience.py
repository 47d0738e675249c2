"""Streaming-RX resilience for the OFDM_COX path.

Reference semantics being mirrored (in host-poll form):
- LDPC-validated decode hunting after a confident-but-mistimed preamble
  (huntForCodeword, ofdm_sync.cpp:572-643).
- Mid-frame preamble preemption: a new preamble inside a pending frame's
  claimed span means the old TX was cut — resync (demodulator.cpp:604-663).
- Idle/symbol timeouts: a pending frame that stops making progress is
  abandoned instead of wedging the receiver
  (demodulator_constants.hpp:36-38, 250 symbols / 10 idle calls).
"""

import numpy as np

from projectultra.config import CodeRate
from projectultra.modem.engine import ModemEngine
from projectultra.protocol import frame_v2 as F
from projectultra.protocol.frame_v2 import WaveformMode


def _cox_pair():
    """TX/RX engines negotiated onto OFDM_COX at R1/2 (connected data
    mode, so TX actually emits Cox frames — 4-way priority,
    modem_engine.cpp:372-397)."""
    tx, rx = ModemEngine(), ModemEngine()
    for m in (tx, rx):
        m.set_waveform_mode(WaveformMode.OFDM_COX)
        m.connected = True
        m.handshake_complete = True
        m.data_code_rate = CodeRate.R1_2
    return tx, rx


def _stream(rx, audio, chunk=960):
    got = []
    rx.on_frame = got.append
    for i in range(0, len(audio), chunk):
        rx.feed_audio(audio[i:i + chunk])
        rx.poll()
    rx.poll()
    return got


def test_interrupted_frame_preempted_by_new_preamble():
    """A multi-codeword frame cut mid-payload, immediately followed by a
    complete frame: the pending 'wait' must be preempted by the new
    preamble and the survivor decoded."""
    tx, rx = _cox_pair()
    long_payload = "x" * 100  # 4 codewords at R1/2
    f1 = F.DataFrame.make_data("W1AW", "VE3ABC", 1, long_payload)
    audio1 = tx.transmit(f1.serialize())
    f2 = F.DataFrame.make_data("W1AW", "VE3ABC", 2, "survivor frame")
    audio2 = tx.transmit(f2.serialize())

    cut = audio1[:int(len(audio1) * 0.55)]  # CW0 intact, later CWs gone
    audio = np.concatenate([cut, np.zeros(1000, np.float32), audio2,
                            np.zeros(8000, np.float32)])
    got = _stream(rx, audio)

    texts = [F.DataFrame.deserialize(fr.frame_bytes).payload_as_text()
             for fr in got
             if F.DataFrame.deserialize(fr.frame_bytes) is not None
             and all(fr.cw_ok)]
    assert "survivor frame" in texts


def test_mistimed_preamble_rescued_by_hunting(monkeypatch):
    """Detection skewed 100 samples early (beyond the 48-sample CP): the
    straight decode fails, the LDPC hunt recovers the +100 offset and the
    frame decodes."""
    from projectultra.sync import schmidl_cox as SC
    tx, rx = _cox_pair()
    frame = F.DataFrame.make_data("W1AW", "VE3ABC", 3, "hunted frame")
    audio = tx.transmit(frame.serialize())

    real_detect = SC.detect_preamble

    def skewed(config, samples, *a, **kw):
        det = dict(real_detect(config, samples, *a, **kw))
        det["lts_start"] = det["lts_start"] - 100
        return det

    monkeypatch.setattr(SC, "detect_preamble", skewed)
    rx2 = rx
    got = []
    rx2.on_frame = got.append
    rx2.feed_audio(np.concatenate([audio, np.zeros(8000, np.float32)]))
    rx2.poll()

    assert len(got) == 1 and all(got[0].cw_ok)
    df = F.DataFrame.deserialize(got[0].frame_bytes)
    assert df and df.payload_as_text() == "hunted frame"


def test_pending_frame_idle_timeout_releases_receiver():
    """A frame cut mid-payload followed by silence must not wedge the
    receiver: after COX_MAX_IDLE_POLLS it is abandoned, and a later frame
    decodes normally."""
    tx, rx = _cox_pair()
    f1 = F.DataFrame.make_data("W1AW", "VE3ABC", 1, "y" * 100)
    cut = tx.transmit(f1.serialize())
    cut = cut[:int(len(cut) * 0.55)]

    got = []
    rx.on_frame = got.append
    rx.feed_audio(cut)
    for _ in range(rx.COX_MAX_IDLE_POLLS + 3):
        rx.poll()
    assert got == []
    assert rx._cox_wait is None  # pending state released

    f2 = F.DataFrame.make_data("W1AW", "VE3ABC", 2, "after timeout")
    rx.feed_audio(np.concatenate([tx.transmit(f2.serialize()),
                                  np.zeros(8000, np.float32)]))
    rx.poll()
    texts = [F.DataFrame.deserialize(fr.frame_bytes).payload_as_text()
             for fr in got if all(fr.cw_ok)]
    assert texts == ["after timeout"]


def test_long_frame_fills_buffer_still_detected():
    """A ~6 s frame (400-byte payload, R1/4) leaves <2% noise offsets in
    the detection view.  The energy gate's noise floor must be a running
    MINIMUM (hasMinimumEnergy, ofdm_sync.cpp:20-50 tracks min energy) —
    a low-QUANTILE floor reads signal energy on such buffers and zeroes
    ~30% of the preamble's own plateau windows, killing detection of
    long frames at ANY SNR (regression: caught by the 400-byte
    calibration rows at 25 dB AWGN)."""
    from projectultra.config import Modulation
    from projectultra.sim import watterson as W
    import jax
    import jax.numpy as jnp

    tx, rx = _cox_pair()
    for m in (tx, rx):
        m.data_modulation = Modulation.DQPSK
        m.data_code_rate = CodeRate.R1_4
    frame = F.DataFrame.make_data("AA1AA", "BB2BB", 0, "x" * 400)
    audio = tx.transmit(frame.serialize())
    clean = np.concatenate([np.zeros(2400, np.float32), audio,
                            np.zeros(4000, np.float32)])
    noisy = np.asarray(W.add_noise_active(
        jax.random.PRNGKey(7), jnp.asarray(clean[None, :]), 25.0))[0]

    got = []
    rx.on_frame = got.append
    rx.feed_audio(noisy)
    rx.poll()
    assert len(got) == 1 and all(got[0].cw_ok)
    df = F.DataFrame.deserialize(got[0].frame_bytes)
    assert df and df.payload_as_text() == "x" * 400
