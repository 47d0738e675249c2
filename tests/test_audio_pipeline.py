"""AudioEngine (loopback/file backends) + RxPipeline streaming tests.

Reference: src/gui/audio_engine.cpp (loopback sim), rx_pipeline.cpp (the
reference's is known-buggy per docs/KNOWN_BUGS.md BUG-002; ours works).
"""

import numpy as np
import jax
import jax.numpy as jnp

from projectultra.modem.audio import AudioEngine, LoopbackBackend, FileBackend
from projectultra.modem.engine import ModemEngine
from projectultra.modem.rx_pipeline import RxPipeline
from projectultra.protocol import frame_v2 as F
from projectultra.sim import watterson as W


def test_audio_loopback_with_channel():
    def channel(audio):
        a = jnp.asarray(np.concatenate(
            [audio, np.zeros(4000, np.float32)])[None, :])
        a = W.add_noise_active(jax.random.PRNGKey(0), a, 12.0)
        return np.asarray(a)[0]

    engine = AudioEngine(LoopbackBackend(channel))
    modem = ModemEngine()
    frames = []
    modem.on_frame = frames.append
    engine.set_rx_callback(modem.feed_audio)

    tx_modem = ModemEngine()
    frame = F.DataFrame.make_data("W1AW", "VE3ABC", 5, "audio engine path")
    engine.play(tx_modem.transmit(frame.serialize()))
    engine.pump()
    modem.poll()
    assert len(frames) == 1
    df = F.DataFrame.deserialize(frames[0].frame_bytes)
    assert df and df.payload_as_text() == "audio engine path"


def test_file_backend_roundtrip(tmp_path):
    path = str(tmp_path / "capture.f32")
    engine = AudioEngine(FileBackend(tx_path=path))
    audio = np.sin(np.linspace(0, 100, 48000)).astype(np.float32)
    engine.play(audio)
    engine.pump()
    got = np.fromfile(path, dtype=np.float32)
    np.testing.assert_array_equal(got, audio)

    rx_engine = AudioEngine(FileBackend(rx_path=path))
    received = []
    rx_engine.set_rx_callback(received.append)
    rx_engine.backend.replay()
    np.testing.assert_array_equal(np.concatenate(received), audio)


def test_rx_pipeline_persistent_engine_mixed_traffic():
    """One persistent engine across feeds (no per-chunk construction), with
    mixed PING + frame traffic in a single stream and a non-default code
    rate that must round-trip into the decode path."""
    from projectultra.config import CodeRate

    tx_modem = ModemEngine()
    tx_modem.connected = True
    tx_modem.handshake_complete = True
    tx_modem.set_waveform_mode(F.WaveformMode.MC_DPSK)
    tx_modem.data_code_rate = CodeRate.R1_2
    frame = F.DataFrame.make_data("W1AW", "VE3ABC", 2, "after ping")
    audio = np.concatenate([
        tx_modem.transmit_ping(), np.zeros(2000, np.float32),
        tx_modem.transmit(frame.serialize()), np.zeros(4000, np.float32)])

    pipe = RxPipeline(rate=CodeRate.R1_2)
    eng0 = pipe._engine
    for i in range(0, len(audio), 4800):
        pipe.feed_audio(audio[i:i + 4800])
    assert pipe._engine is eng0          # persistent, not per-chunk
    assert pipe._engine.data_code_rate == CodeRate.R1_2  # config round-trips
    assert pipe.has_frame()
    df = F.DataFrame.deserialize(pipe.get_frame())
    assert df and df.payload_as_text() == "after ping"


def test_rx_pipeline_streaming():
    tx_modem = ModemEngine()
    frame = F.DataFrame.make_data("W1AW", "VE3ABC", 9, "pipeline frame")
    audio = np.concatenate([tx_modem.transmit(frame.serialize()),
                            np.zeros(4000, np.float32)])
    pipe = RxPipeline()
    ready = False
    for i in range(0, len(audio), 4800):
        ready = pipe.feed_audio(audio[i:i + 4800]) or ready
    assert ready  # feed_audio's frame-ready return contract
    assert pipe.has_frame()
    df = F.DataFrame.deserialize(pipe.get_frame())
    assert df and df.payload_as_text() == "pipeline frame"


def test_rx_pipeline_dpsk_mode():
    """RxPipeline(mode=DPSK) must actually run the single-carrier DPSK RX
    path (review finding: WF.create used to fall through to OFDM_COX)."""
    from projectultra.protocol.frame_v2 import WaveformMode
    tx = ModemEngine()
    tx.set_waveform_mode(WaveformMode.DPSK)
    tx.connect_waveform = WaveformMode.DPSK
    frame = F.ControlFrame.make_ack("W1AW", "VE3ABC", 4).serialize()
    audio = np.concatenate([tx.transmit(frame), np.zeros(8000, np.float32)])

    pipe = RxPipeline(mode=WaveformMode.DPSK)
    assert pipe._engine.waveform_mode == WaveformMode.DPSK
    for i in range(0, len(audio), 4800):
        pipe.feed_audio(audio[i:i + 4800])
    assert pipe.has_frame()
    ctrl = F.ControlFrame.deserialize(pipe.get_frame())
    assert ctrl is not None and ctrl.seq == 4


def test_rx_pipeline_reset_then_fresh_stream():
    """reset() must clear acquisition bookkeeping so frames in a NEW stream
    decode immediately (review finding: stale _dpsk_searched_until skipped
    every search until the new stream outgrew the old one)."""
    tx = ModemEngine()
    frame1 = F.DataFrame.make_data("W1AW", "VE3ABC", 1, "before reset")
    frame2 = F.DataFrame.make_data("W1AW", "VE3ABC", 2, "after reset")
    pipe = RxPipeline()
    # Feed a partial frame, then reset mid-stream.
    audio1 = tx.transmit(frame1.serialize())
    pipe.feed_audio(audio1[:len(audio1) // 2])
    pipe.reset()
    assert not pipe.has_frame()
    # A fresh full frame must decode.
    audio2 = np.concatenate([tx.transmit(frame2.serialize()),
                             np.zeros(4000, np.float32)])
    for i in range(0, len(audio2), 4800):
        pipe.feed_audio(audio2[i:i + 4800])
    assert pipe.has_frame()
    df = F.DataFrame.deserialize(pipe.get_frame())
    assert df and df.payload_as_text() == "after reset"
