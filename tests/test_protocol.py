"""Protocol stack tests: ARQ, connection FSM, file transfer, and a full
two-station over-the-air session (cli_simulator semantics).

Reference: tests/test_protocol.cpp, test_selective_repeat.cpp,
tools/cli_simulator.cpp.
"""

import numpy as np
import pytest

from projectultra.config import Modulation, CodeRate
from projectultra.protocol import frame_v2 as F
from projectultra.protocol.arq import (ARQConfig, ARQMode, StopAndWaitARQ,
                                           SelectiveRepeatARQ)
from projectultra.protocol.connection import (Connection, ConnectionConfig,
                                                  ConnectionState,
                                                  recommend_data_mode)
from projectultra.protocol.frame_v2 import WaveformMode


def _link(a, b):
    """Directly connect two ARQ controllers frame-wise."""
    a.on_transmit = b.on_frame_received
    b.on_transmit = a.on_frame_received


def test_stop_and_wait_roundtrip():
    a, b = StopAndWaitARQ(), StopAndWaitARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    _link(a, b)
    got = []
    b.on_data_received = got.append
    done = []
    a.on_send_complete = done.append
    assert a.send_data(b"hello")
    assert got == [b"hello"]
    assert done == [True]
    assert a.is_ready_to_send()


def test_stop_and_wait_retry_then_fail():
    a = StopAndWaitARQ(ARQConfig(ack_timeout_ms=100, max_retries=2))
    a.set_callsigns("W1AW", "VE3ABC")
    sent = []
    a.on_transmit = sent.append
    done = []
    a.on_send_complete = done.append
    a.send_data(b"x")
    assert len(sent) == 1
    a.tick(150)  # timeout -> retry 1
    a.tick(150)  # retry 2
    a.tick(150)  # exceeds max_retries -> fail
    assert len(sent) == 3
    assert done == [False]
    assert a.stats.failed == 1


def test_selective_repeat_window_and_sack():
    cfg = ARQConfig(window_size=4)
    a, b = SelectiveRepeatARQ(cfg), SelectiveRepeatARQ(cfg)
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    got = []
    b.on_data_received = got.append

    # Capture A's frames without delivering, to simulate loss/reorder.
    a_frames = []
    a.on_transmit = a_frames.append
    b.on_transmit = a.on_frame_received

    for i in range(4):
        assert a.send_data(f"msg{i}".encode())
    assert not a.is_ready_to_send()
    assert len(a_frames) == 4

    # Deliver out of order: 1, 0, 3, 2 — receiver reorders.
    for idx in (1, 0, 3, 2):
        b.on_frame_received(a_frames[idx])
    assert got == [b"msg0", b"msg1", b"msg2", b"msg3"]
    assert b.stats.out_of_order > 0
    # SACKs flowed back to A: window fully acked.
    assert a.in_flight == 0
    assert a.is_ready_to_send()


def test_selective_repeat_nack_retransmit():
    cfg = ARQConfig(window_size=4)
    a = SelectiveRepeatARQ(cfg)
    a.set_callsigns("W1AW", "VE3ABC")
    sent = []
    a.on_transmit = sent.append
    a.send_data(b"payload")
    nack = F.ControlFrame.make_nack("VE3ABC", "W1AW", 0, 0x01)
    a.on_frame_received(nack.serialize())
    assert len(sent) == 2  # original + retransmit
    assert a.stats.retransmissions == 1


def test_recommend_data_mode_table():
    assert recommend_data_mode(31) == (Modulation.QAM16, CodeRate.R3_4)
    assert recommend_data_mode(26) == (Modulation.QAM16, CodeRate.R2_3)
    assert recommend_data_mode(21) == (Modulation.DQPSK, CodeRate.R2_3)
    assert recommend_data_mode(17) == (Modulation.DQPSK, CodeRate.R1_2)
    assert recommend_data_mode(13) == (Modulation.DQPSK, CodeRate.R1_4)
    assert recommend_data_mode(5) == (Modulation.DBPSK, CodeRate.R1_4)


def test_connection_handshake_frame_level():
    """CONNECT/CONNECT_ACK exchange at serialized-frame level."""
    a, b = Connection(), Connection()
    a.set_local_callsign("W1AW")
    b.set_local_callsign("VE3ABC")
    b.set_measured_snr(21.0)
    # Wire transmit paths directly.
    a.on_transmit = b.on_frame_received
    b.on_transmit = a.on_frame_received
    pings = []
    a.on_ping_tx = lambda: pings.append(1)

    assert a.connect("VE3ABC")
    assert a.state == ConnectionState.PROBING
    assert pings == [1]
    a.on_pong_received()  # modem detected PONG
    # CONNECT flowed to B, which auto-accepted with CONNECT_ACK.
    assert b.state == ConnectionState.CONNECTED
    assert a.state == ConnectionState.CONNECTED
    assert b.remote_call == "W1AW" and a.remote_call == "VE3ABC"
    # SNR 21 -> DQPSK R2/3, MC_DPSK < 17? 21 >= 17 -> OFDM_COX negotiated.
    assert b.negotiated_mode == WaveformMode.OFDM_COX
    assert a.data_modulation == Modulation.DQPSK
    assert a.data_code_rate == CodeRate.R2_3

    # Data both ways via ARQ.
    got_b, got_a = [], []
    b.on_message_received = got_b.append
    a.on_message_received = got_a.append
    assert a.send_message("hello b")
    assert got_b == ["hello b"]
    assert b.send_message("hello a")
    assert got_a == ["hello a"]

    # Teardown.
    a.disconnect()
    assert b.state == ConnectionState.DISCONNECTED
    a.tick(60000)
    assert a.state == ConnectionState.DISCONNECTED


def test_stale_ack_does_not_ack_window():
    """Regression (code review): an ACK whose seq lies outside the TX
    window — e.g. the MODE_CHANGE acknowledgment, which uses seq=0 on
    the wire — must not walk tx_base and falsely complete in-flight
    frames (a mid-transfer mode change was 'delivering' every
    outstanding chunk the peer never received)."""
    cfg = ARQConfig(window_size=4)
    tx = SelectiveRepeatARQ(cfg)
    rx = SelectiveRepeatARQ(cfg)
    tx.set_callsigns("W1AW", "VE3ABC")
    rx.set_callsigns("VE3ABC", "W1AW")
    sent = []
    tx.on_transmit = sent.append
    rx.on_transmit = lambda f: tx.on_frame_received(f)
    rx.on_data_received = lambda p: None

    # Advance tx_base past 0 with real traffic.
    for i in range(3):
        assert tx.send_data(bytes([i]))
    for f in list(sent):
        rx.on_frame_received(f)
    assert tx.in_flight == 0 and tx.tx_base == 3
    sent.clear()

    # Two frames in flight; a stale seq-0 ACK (mode-change style) arrives.
    assert tx.send_data(b"x")
    assert tx.send_data(b"y")
    assert tx.in_flight == 2
    stale = F.ControlFrame.make_ack("VE3ABC", "W1AW", 0)
    tx.on_frame_received(stale.serialize())
    assert tx.in_flight == 2, "stale ACK must not complete in-flight frames"
    assert tx.tx_base == 3


def test_sack_coalescing_counts_and_gap_flush(tmp_path):
    """sack_every=3 must send one SACK per 3 in-order data frames, SACK
    immediately on a window gap (the sender's fast-retransmit signal),
    and still deliver everything; the cumulative base+bitmap wire format
    is unchanged."""
    cfg = ARQConfig(window_size=4)
    tx = SelectiveRepeatARQ(cfg)
    rx = SelectiveRepeatARQ(cfg)
    rx.sack_every = 3
    tx.set_callsigns("W1AW", "VE3ABC")
    rx.set_callsigns("VE3ABC", "W1AW")
    sent, delivered = [], []
    tx.on_transmit = sent.append
    rx.on_transmit = lambda f: tx.on_frame_received(f)
    rx.on_data_received = delivered.append

    # Three in-order frames -> exactly ONE SACK.
    for i in range(3):
        assert tx.send_data(bytes([i]))
    assert len(sent) == 3
    s0 = rx.stats.sacks_sent
    for f in sent[:3]:
        rx.on_frame_received(f)
    assert rx.stats.sacks_sent - s0 == 1
    assert delivered == [bytes([0]), bytes([1]), bytes([2])]
    assert tx.in_flight == 0

    # A dropped frame: the out-of-order arrival SACKs IMMEDIATELY (gap
    # bitmap = fast-retransmit signal), and recovery completes.
    sent.clear()
    for i in range(3, 6):
        assert tx.send_data(bytes([i]))
    dropped = sent[0]
    s1 = rx.stats.sacks_sent
    rx.on_frame_received(sent[1])      # out of order -> immediate SACK
    assert rx.stats.sacks_sent - s1 == 1
    rx.on_frame_received(sent[2])      # still a hole -> immediate SACK
    assert rx.stats.sacks_sent - s1 == 2
    rx.on_frame_received(dropped)      # hole heals -> immediate SACK
    assert delivered[-3:] == [bytes([3]), bytes([4]), bytes([5])]
    assert tx.in_flight == 0

    # Holdoff flush: 2 in-order frames (below sack_every) then tick past
    # sack_holdoff_ms -> the pending SACK flushes.
    sent.clear()
    for i in range(6, 8):
        assert tx.send_data(bytes([i]))
    s2 = rx.stats.sacks_sent
    for f in sent:
        rx.on_frame_received(f)
    assert rx.stats.sacks_sent - s2 == 0   # coalescing held it back
    rx.tick(rx.sack_holdoff_ms + 1)
    assert rx.stats.sacks_sent - s2 == 1
    assert tx.in_flight == 0


def test_pipelined_transfer_message_ack_not_miscounted(tmp_path):
    """Regression (code review): with the PIPELINED chunker, a text
    message's ACK arriving while file chunks are still outstanding must
    route to on_message_sent, not on_chunk_acked — the old
    is_in_progress() routing decremented the chunk counter and could
    report the transfer COMPLETE with its last chunk unacknowledged."""
    a, b = Connection(), Connection()
    a.set_local_callsign("W1AW")
    b.set_local_callsign("VE3ABC")
    # Manual delivery queues so frames can be held in flight.
    a_out, b_out = [], []
    a.on_transmit = a_out.append
    b.on_transmit = b_out.append
    b.file_transfer.receive_dir = str(tmp_path / "rx")
    (tmp_path / "rx").mkdir()
    a.connect("VE3ABC")
    # Drain the handshake synchronously.
    for _ in range(6):
        while a_out:
            b.on_frame_received(a_out.pop(0))
        while b_out:
            a.on_frame_received(b_out.pop(0))
        if a.is_connected and b.is_connected:
            break
        a.on_pong_received()
    assert a.is_connected and b.is_connected
    a_out.clear(), b_out.clear()

    src = tmp_path / "payload.bin"
    content = bytes(np.random.default_rng(3).integers(
        0, 256, 480, dtype=np.uint8))  # 2 chunks at 250 B
    src.write_bytes(content)
    sent_events = []
    msg_events = []
    a.file_transfer.on_sent = lambda ok, msg: sent_events.append(ok)
    a.on_message_sent = msg_events.append
    received = []
    b.file_transfer.on_received = lambda path, ok: received.append((path, ok))

    # A message queued BEFORE the file: its completion (lowest seq) fires
    # while file chunks are still outstanding.
    assert a.send_message("before-transfer")
    assert a.send_file(str(src))
    # Pipelined pump queued FILE_START + both chunks behind the message.
    assert len(a_out) >= 4
    held_last = a_out.pop()       # hold the LAST chunk in flight
    while a_out:                  # deliver the rest; ACKs flow back
        b.on_frame_received(a_out.pop(0))
    while b_out:
        a.on_frame_received(b_out.pop(0))
    # The message completed; the transfer must still be waiting on the
    # held chunk — the old is_in_progress() routing counted the message
    # ACK as a chunk ACK and fired on_sent(True) one chunk early here.
    assert msg_events == [True]
    assert not sent_events, "message ACK was miscounted as a chunk ACK"
    assert a.file_transfer.is_in_progress()
    assert not received

    # Deliver the held last chunk: NOW the transfer completes.
    b.on_frame_received(held_last)
    while b_out:
        a.on_frame_received(b_out.pop(0))
    assert sent_events == [True]
    assert received and received[0][1]
    with open(received[0][0], "rb") as f:
        assert f.read() == content


def test_file_transfer_roundtrip(tmp_path):
    a, b = Connection(), Connection()
    a.set_local_callsign("W1AW")
    b.set_local_callsign("VE3ABC")
    a.on_transmit = b.on_frame_received
    b.on_transmit = a.on_frame_received
    b.file_transfer.receive_dir = str(tmp_path)
    a.connect("VE3ABC")
    a.on_pong_received()
    assert a.is_connected and b.is_connected

    src = tmp_path / "payload.txt"
    content = b"The quick brown fox jumps over the lazy dog. " * 40
    src.write_bytes(content)
    received = []
    b.file_transfer.on_received = lambda path, ok: received.append((path, ok))
    assert a.send_file(str(src))
    assert received and received[0][1]
    out = open(received[0][0], "rb").read()
    assert out == content


def test_two_station_over_the_air():
    """Full acoustic session: chirp PING/PONG, CONNECT via MC-DPSK audio,
    data frames at negotiated rate (cli_simulator.cpp:175-380 semantics)."""
    from projectultra.protocol.engine import ProtocolEngine

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(15.0)

    # Acoustic link: each engine's TX audio is fed into the other's RX.
    a.on_tx_audio = lambda audio: b.feed_audio(
        np.concatenate([audio, np.zeros(4000, np.float32)]))
    b.on_tx_audio = lambda audio: a.feed_audio(
        np.concatenate([audio, np.zeros(4000, np.float32)]))

    messages_b = []
    b.connection.on_message_received = messages_b.append

    assert a.connect("VE3ABC")
    # PING chirp went to B; B (disconnected) answered with PONG chirp;
    # A (PROBING) took it as PONG and sent CONNECT over MC-DPSK audio;
    # B auto-accepted with CONNECT_ACK audio.
    assert a.connection.is_connected, a.connection.state
    assert b.connection.is_connected, b.connection.state
    assert b.connection.remote_call == "W1AW"

    assert a.send_message("over the air!")
    assert messages_b == ["over the air!"]


def test_file_transfer_over_the_air(tmp_path):
    """A file crosses the acoustic link: FILE_START/FILE_DATA chunking,
    compression, SR-ARQ and reassembly all over modulated audio."""
    from projectultra.protocol.engine import ProtocolEngine

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(15.0)
    b.connection.file_transfer.receive_dir = str(tmp_path)

    a.on_tx_audio = lambda audio: b.feed_audio(
        np.concatenate([audio, np.zeros(4000, np.float32)]))
    b.on_tx_audio = lambda audio: a.feed_audio(
        np.concatenate([audio, np.zeros(4000, np.float32)]))

    assert a.connect("VE3ABC")
    assert a.connection.is_connected and b.connection.is_connected

    src = tmp_path / "otaf.txt"
    content = (b"HF file transfer exercises chunking + ARQ over audio. " * 12)
    src.write_bytes(content)
    received = []
    b.connection.file_transfer.on_received = \
        lambda path, ok: received.append((path, ok))
    assert a.connection.send_file(str(src))
    # Allow ARQ retry timers to fire if a mode change straddled a frame.
    for _ in range(30):
        if received:
            break
        a.tick(1000)
        b.tick(1000)
    assert received and received[0][1]
    assert open(received[0][0], "rb").read() == content


def test_mode_change_mid_session():
    """MODE_CHANGE control frame updates both ends' data mode
    (test_mode_change.cpp semantics)."""
    a, b = Connection(), Connection()
    a.set_local_callsign("W1AW")
    b.set_local_callsign("VE3ABC")
    a.on_transmit = b.on_frame_received
    b.on_transmit = a.on_frame_received
    a.connect("VE3ABC")
    a.on_pong_received()
    assert a.is_connected and b.is_connected

    changes = []
    b.on_data_mode_changed = lambda m, r, s: changes.append((m, r))
    assert a.request_mode_change(Modulation.QAM16, CodeRate.R2_3)
    assert a.data_modulation == Modulation.QAM16
    assert b.data_modulation == Modulation.QAM16
    assert b.data_code_rate == CodeRate.R2_3
    assert changes and changes[-1] == (Modulation.QAM16, CodeRate.R2_3)
    # Data still flows after the change.
    got = []
    b.on_message_received = got.append
    assert a.send_message("post-change")
    assert got == ["post-change"]


def test_many_messages_soak():
    """200 messages each way over SR-ARQ with keepalive ticks interleaved —
    seq accounting and window reuse stay consistent over a long session."""
    a, b = Connection(), Connection()
    a.set_local_callsign("W1AW")
    b.set_local_callsign("VE3ABC")
    a.on_transmit = b.on_frame_received
    b.on_transmit = a.on_frame_received
    a.connect("VE3ABC")
    a.on_pong_received()
    assert a.is_connected and b.is_connected

    got_b, got_a = [], []
    b.on_message_received = got_b.append
    a.on_message_received = got_a.append
    for i in range(200):
        assert a.send_message(f"a{i}")
        assert b.send_message(f"b{i}")
        if i % 25 == 0:
            a.tick(1000)
            b.tick(1000)
    assert got_b == [f"a{i}" for i in range(200)]
    assert got_a == [f"b{i}" for i in range(200)]
    assert a.is_connected and b.is_connected


def test_over_the_air_lossy_soak():
    """60 messages each way over the FULL modem path on an 8 dB moderate
    Watterson channel: frames genuinely get lost and the 45 s SR-ARQ
    timeout retransmissions must recover every one, in order, with the
    connection alive throughout (the direct-wire soak above cannot
    exercise loss recovery)."""
    import jax
    import jax.numpy as jnp
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(11)
    counter = [0]

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        a = W.watterson(jax.random.fold_in(key, counter[0]), a,
                        W.PRESETS["moderate"](8.0))
        return np.asarray(a)[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(8.0)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append

    a.connect("VE3ABC")
    assert a.connection.is_connected and b.connection.is_connected

    N = 60
    ia = ib = 0
    for _ in range(2000):
        if ia < N and a.send_message(f"soak-a-{ia:03d}"):
            ia += 1
        if ib < N and b.send_message(f"soak-b-{ib:03d}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if ia >= N and ib >= N and len(got_a) >= N and len(got_b) >= N:
            break

    assert got_b == [f"soak-a-{i:03d}" for i in range(N)]
    assert got_a == [f"soak-b-{i:03d}" for i in range(N)]
    assert (a.connection.arq.stats.retransmissions
            + b.connection.arq.stats.retransmissions) > 0  # loss really hit
    assert a.connection.is_connected and b.connection.is_connected


def test_file_transfer_over_lossy_air(tmp_path):
    """File transfer across an 8 dB moderate fading channel: chunks get
    lost and the ARQ timeout path must still deliver a byte-identical
    file.  The initiator FORCES R1/4 (the forced-rate plumbing of the
    CONNECT frame): auto-negotiation picks the data rate from the
    frame-SNR estimate, which reads high under fading (the reference's
    own types.hpp documents the inflated scale), and the resulting R1/2
    multi-codeword chunks exceed the channel's envelope — faithfully
    mirroring the reference's behavior, so the test pins the envelope
    the system actually supports."""
    import jax
    import jax.numpy as jnp
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(23)
    counter = [0]

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        a = W.watterson(jax.random.fold_in(key, counter[0]), a,
                        W.PRESETS["moderate"](8.0))
        return np.asarray(a)[0]

    from projectultra.config import CodeRate

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(8.0)
    a.connection.config.forced_code_rate = CodeRate.R1_4
    b.connection.file_transfer.receive_dir = str(tmp_path)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))

    assert a.connect("VE3ABC")
    src = tmp_path / "lossy.bin"
    rng = np.random.default_rng(5)
    content = bytes(rng.integers(0, 256, 600, dtype=np.uint8))
    src.write_bytes(content)
    received = []
    b.connection.file_transfer.on_received = \
        lambda path, ok: received.append((path, ok))
    assert a.connection.send_file(str(src))
    for _ in range(160):  # 45 s ARQ timeouts need virtual time
        if received:
            break
        a.tick(5000)
        b.tick(5000)
    assert received and received[0][1], "file transfer did not complete"
    assert open(received[0][0], "rb").read() == content


def test_calibrated_tables_and_waveform_pick():
    """Round-3 calibrated negotiation: thresholds live on TRUE wideband SNR
    (measured envelopes, tools/calibrate_mode_table.py) — everything below
    the ~14 dB Schmidl-Cox acquisition floor routes to MC_DPSK."""
    from projectultra.protocol.connection import (
        Connection, ConnectionConfig, recommend_data_mode_calibrated)
    from projectultra.config import Modulation, CodeRate
    from projectultra.protocol.frame_v2 import WaveformMode

    assert recommend_data_mode_calibrated(8.0) == \
        (Modulation.DBPSK, CodeRate.R1_4)
    assert recommend_data_mode_calibrated(12.0) == \
        (Modulation.DQPSK, CodeRate.R1_4)
    assert recommend_data_mode_calibrated(16.0) == \
        (Modulation.DQPSK, CodeRate.R1_2)
    assert recommend_data_mode_calibrated(21.0) == \
        (Modulation.QAM16, CodeRate.R2_3)

    c = Connection(ConnectionConfig(calibrated_snr=True))
    c.set_measured_snr(8.0)
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MC_DPSK
    c.set_measured_snr(16.0)  # ambiguous 15-17 band routes robust
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MC_DPSK
    c.set_measured_snr(18.0)
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.OFDM_COX
    c.set_measured_snr(-6.0)
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MFSK
    # Parity default unchanged: 8 dB on the INFLATED scale -> MC_DPSK, and
    # 18 dB inflated -> OFDM_COX.
    d = Connection(ConnectionConfig())
    d.set_measured_snr(8.0)
    assert d.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MC_DPSK
    d.set_measured_snr(18.0)
    assert d.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.OFDM_COX


def test_wideband_snr_estimator_tracks_truth():
    """The engine's frame-power-vs-noise-floor estimate: dB-linear
    tracking of true wideband SNR, bounded conservative bias, and NEVER
    optimistic (the failure mode that walks negotiation beyond the
    envelope).  MC_DPSK's data span genuinely runs ~3.7 dB below the
    chirp-dominated nominal scale, hence the asymmetric band; DPSK's
    constant-envelope frames have no such offset and pin a tight band.
    (Reference estimators read +10/+30 dB with 4-6 dB fade scatter —
    tools/calibrate_snr.py.)"""
    import jax
    import jax.numpy as jnp
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol import frame_v2 as F
    from projectultra.protocol.frame_v2 import WaveformMode
    from projectultra.sim import watterson as W

    def measure(wf, true_snr):
        tx, rx = ModemEngine(), ModemEngine()
        for m in (tx, rx):
            m.set_waveform_mode(wf)
            m.connect_waveform = wf
        audio = tx.transmit(
            F.ControlFrame.make_ack("AA1AA", "BB2BB", 1).serialize())
        a = jnp.asarray(np.concatenate(
            [np.zeros(2400, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        noisy = W.add_noise_active(jax.random.PRNGKey(31), a, true_snr)
        got = []
        rx.on_frame = got.append
        rx.feed_audio(np.asarray(noisy)[0])
        rx.poll()
        assert got, f"no decode at {true_snr} dB"
        return got[0].wideband_snr_db

    e6 = measure(WaveformMode.MC_DPSK, 6.0)
    e14 = measure(WaveformMode.MC_DPSK, 14.0)
    assert -5.0 <= e6 - 6.0 <= 1.0, e6        # conservative, not optimistic
    assert -5.0 <= e14 - 14.0 <= 1.0, e14
    assert 6.5 <= e14 - e6 <= 9.5, (e6, e14)  # dB-linear tracking

    d8 = measure(WaveformMode.DPSK, 8.0)
    assert -2.0 <= d8 - 8.0 <= 1.0, d8        # no chirp offset: tight band


def test_file_transfer_over_lossy_air_auto_calibrated(tmp_path):
    """VERDICT r2 #2 done-criterion: the 8 dB moderate-fading file transfer
    with AUTO negotiation — no forced code rate — under calibrated_snr.
    The wideband estimate keeps the negotiated mode inside the channel
    envelope (MC_DPSK R1/4-class), where the reference-parity inflated
    scale auto-picked OFDM/R1_2 beyond it (see the forced-R1/4 twin test
    above, kept as the parity pin)."""
    import jax
    import jax.numpy as jnp
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(23)
    counter = [0]

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        a = W.watterson(jax.random.fold_in(key, counter[0]), a,
                        W.PRESETS["moderate"](8.0))
        return np.asarray(a)[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.config.calibrated_snr = True
    b.connection.config.calibrated_snr = True
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(8.0)
    b.connection.file_transfer.receive_dir = str(tmp_path)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))

    assert a.connect("VE3ABC")
    from projectultra.config import CodeRate
    assert b.connection.data_code_rate == CodeRate.R1_4  # within envelope
    src = tmp_path / "lossy_auto.bin"
    rng = np.random.default_rng(5)
    content = bytes(rng.integers(0, 256, 600, dtype=np.uint8))
    src.write_bytes(content)
    received = []
    b.connection.file_transfer.on_received = \
        lambda path, ok: received.append((path, ok))
    assert a.connection.send_file(str(src))
    for _ in range(160):
        if received:
            break
        a.tick(5000)
        b.tick(5000)
    assert received and received[0][1], "file transfer did not complete"
    assert open(received[0][0], "rb").read() == content


def test_fade_spread_benign_relaxation():
    """Round-3 fade detector: calibrated negotiation relaxes the MC_DPSK
    routing floor to 11 dB only on EVIDENCE of a flat channel (sustained
    fade_spread < 2.5 dB); unknown or high spread keeps the conservative
    17 dB guard band, and a single high reading disqualifies benign for a
    while (decaying max)."""
    from projectultra.protocol.connection import (
        Connection, ConnectionConfig)
    from projectultra.protocol.frame_v2 import WaveformMode

    c = Connection(ConnectionConfig(calibrated_snr=True))
    c.set_measured_snr(12.0)  # spread unknown -> conservative
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MC_DPSK
    c.set_measured_snr(12.0, 0.2)  # flat channel proven
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.OFDM_COX
    c.set_measured_snr(10.0, 0.2)  # below the relaxed floor: still robust
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MC_DPSK
    c.set_measured_snr(12.0, 6.0)  # fading evidence
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MC_DPSK
    c.set_measured_snr(12.0, 0.2)  # decaying max: 0.7*6 = 4.2 still fading
    assert c.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MC_DPSK
    # Unmeasured frames (-1) leave the fading evidence in place.
    c.set_measured_snr(12.0, -1.0)
    assert c.measured_fade_spread_db > 2.5
    # Parity scale ignores the spread entirely.
    d = Connection(ConnectionConfig())
    d.set_measured_snr(12.0, 0.2)
    assert d.negotiate_mode(0xFF, WaveformMode.AUTO) == WaveformMode.MC_DPSK


def test_fade_spread_metric_separation():
    """The engine's fade-spread metric on a real decoded CONNECT frame:
    AWGN reads ~0.1-0.2 dB, Watterson moderate >= 2.5 dB.  The dual
    chirps join the pool as per-segment-normalized active spans — the
    chirp sweeps 2.4 kHz, so the Watterson two-path echo comb appears as
    envelope ripple on the chirp even at slow Doppler, and the 0.9 s
    training+data body alone would sit under the 1 s trust gate.  Also
    pins the segment-weighted estimator scale: body-only measurement
    under-reads the chirp-led frame ~3 dB vs the active-average truth."""
    import jax
    import jax.numpy as jnp
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol import frame_v2 as F
    from projectultra.sim import watterson as W

    tx = ModemEngine()
    cf = F.ConnectFrame.make_connect(
        "W1AW", "VE3ABC", int(F.ModeCapabilities.ALL), 0, 0xFF, 0xFF)
    audio = tx.transmit(cf.serialize())

    def measure(chan, key):
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        noisy = W.add_noise_active(key, a, 12.0) if chan == "awgn" \
            else W.watterson(key, a, W.PRESETS["moderate"](12.0))
        rx = ModemEngine()
        got = []
        rx.on_frame = got.append
        rx.feed_audio(np.asarray(noisy)[0])
        rx.poll()
        assert got, f"no decode on {chan}"
        return got[0]

    import jax as _j
    fa = measure("awgn", _j.random.PRNGKey(156))
    assert 0.0 <= fa.fade_spread_db < 1.5, fa.fade_spread_db
    assert abs(fa.wideband_snr_db - 12.0) <= 1.5, fa.wideband_snr_db
    fm = measure("moderate", _j.random.PRNGKey(156))
    assert fm.fade_spread_db >= 2.5, fm.fade_spread_db


def test_benign_awgn_session_negotiates_ofdm():
    """End-to-end: at 12 dB TRUE wideband AWGN with calibrated_snr, the
    fade detector proves the channel flat and negotiation picks OFDM_COX
    (deep Cox acquisition floor ~8 dB, PARITY.md deviation 9) instead of
    parking on MC_DPSK below the 17 dB fading guard band — ~4x the
    over-the-air throughput at the same SNR.  Messages must deliver both
    ways."""
    import jax
    import jax.numpy as jnp
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.protocol.frame_v2 import WaveformMode
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(77)
    counter = [0]

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        a = W.add_noise_active(jax.random.fold_in(key, counter[0]), a, 12.0)
        return np.asarray(a)[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    for e in (a, b):
        e.connection.config.calibrated_snr = True
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append

    assert a.connect("VE3ABC")
    assert b.connection.negotiated_mode == WaveformMode.OFDM_COX

    N = 2
    ia = ib = 0
    for _ in range(300):
        if ia < N and a.send_message(f"a{ia}"):
            ia += 1
        if ib < N and b.send_message(f"b{ib}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if (ia >= N and ib >= N
                and len(got_a) >= N and len(got_b) >= N):
            break
    assert got_b == ["a0", "a1"] and got_a == ["b0", "b1"]


def test_otfs_session_over_watterson_good():
    """BEYOND-REFERENCE close-out (VERDICT r4 #7): a full two-station
    over-the-air session pinned at preferred_mode=OTFS_EQ — ping/connect
    handshake, data + ACKs both ways through a Good-channel Watterson,
    clean disconnect.  The reference cannot run this session at all: its
    WaveformFactory silently falls back OTFS->OFDM_COX
    (waveform_factory.cpp:26-30), so OTFS_EQ here rides our own
    delay-Doppler TX/RX (otfs/otfs.py) end to end, with the negotiation
    honoring the preferred mode exactly as app.cpp:408 setPreferredMode
    does for the modes the reference does ship."""
    import jax
    import jax.numpy as jnp
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(61)
    counter = [0]

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        a = W.watterson(jax.random.fold_in(key, counter[0]), a,
                        W.PRESETS["good"](20.0))
        return np.asarray(a)[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    for e in (a, b):
        e.connection.config.preferred_mode = WaveformMode.OTFS_EQ
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(20.0)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append

    assert a.connect("VE3ABC")
    assert a.connection.is_connected and b.connection.is_connected
    # Negotiation honored the preferred mode on BOTH stations — the data
    # frames below really ride the delay-Doppler grid.
    assert a.connection.negotiated_mode == WaveformMode.OTFS_EQ
    assert b.connection.negotiated_mode == WaveformMode.OTFS_EQ
    assert a.modem.waveform_mode == WaveformMode.OTFS_EQ
    assert b.modem.waveform_mode == WaveformMode.OTFS_EQ

    N = 3
    ia = ib = 0
    for _ in range(400):
        if ia < N and a.send_message(f"otfs-a{ia}"):
            ia += 1
        if ib < N and b.send_message(f"otfs-b{ib}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if (ia >= N and ib >= N
                and len(got_a) >= N and len(got_b) >= N):
            break
    assert got_b == [f"otfs-a{i}" for i in range(N)]
    assert got_a == [f"otfs-b{i}" for i in range(N)]

    a.disconnect()
    for _ in range(40):
        if not (a.connection.is_connected or b.connection.is_connected):
            break
        a.tick(500)
        b.tick(500)
    assert not a.connection.is_connected
    assert not b.connection.is_connected
