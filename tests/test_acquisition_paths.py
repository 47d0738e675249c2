"""Acquisition-path isolation (round-4 engine split).

Each per-waveform path owns its cross-poll state behind the shared
contract of modem/acquisition/base.py; these tests exercise the paths
DIRECTLY (no poll loop) — the behavioral equivalence with the pre-split
engine is pinned by the rest of the suite + the stream matrix.
"""

import numpy as np
import jax.numpy as jnp

from projectultra.config import Modulation, CodeRate
from projectultra.modem.engine import ModemEngine
from projectultra.protocol import frame_v2 as F
from projectultra.protocol.frame_v2 import WaveformMode


def _engine(wf=WaveformMode.OFDM_COX):
    e = ModemEngine()
    e.set_waveform_mode(wf)
    e.connected = True
    e.handshake_complete = True
    return e


def test_paths_own_their_state_and_reset():
    e = _engine()
    e.dpsk.pending = ("x",)
    e.dpsk.searched_until = 77
    e.cox.pending = (123, 0.5)
    e.cox.deep_rejected = {5}
    e.chirp.last_key = (0, 1, 2, 3)
    e.otfs.waiting = True
    e.reset_rx()
    assert e.dpsk.pending is None and e.dpsk.searched_until == 0
    assert e.cox.pending is None and e.cox.deep_rejected == set()
    assert e.chirp.last_key is None and e.otfs.waiting is False
    # compat properties mirror path state
    assert e._dpsk_pending is None and e._cox_pending is None
    assert e._chirp_last_key is None and e._otfs_waiting is False


def test_paths_return_none_on_empty_buffer():
    e = _engine()
    assert e.cox.try_once() is None
    assert e.dpsk.try_once() is None
    e.set_waveform_mode(WaveformMode.OTFS_EQ)
    assert e.otfs.try_once() is None
    # chirp acquire on an empty buffer: no events, nothing consumed
    assert e.chirp.acquire_once(False) == 0
    assert e._rx_consumed == 0


def test_cox_path_decodes_in_isolation():
    """CoxPath.try_once drives detection+decode end-to-end when called
    directly (not through the engine poll loop)."""
    e = _engine()
    tx = _engine()
    frame = F.DataFrame.make_data("AA1AA", "BB2BB", 3, "path test").serialize()
    audio = tx.transmit(frame)
    sig = np.concatenate([np.zeros(2400, np.float32), audio,
                          np.zeros(4000, np.float32)])
    rng = np.random.default_rng(0)
    e.feed_audio(sig + rng.normal(0, 0.01, len(sig)).astype(np.float32))
    got = []
    e.on_frame = got.append
    r = e.cox.try_once()
    assert r == 1 and got and got[0].frame_bytes == frame
    assert e.frames_received == 1


def test_mode_change_rearms_chirp_search_via_path():
    e = _engine()
    e.chirp.last_key = (0, 100, WaveformMode.OFDM_COX, 1)
    e.set_waveform_mode(WaveformMode.MC_DPSK)
    assert e.chirp.last_key is None


def test_deliver_updates_engine_bookkeeping():
    from projectultra.modem.types import DecodedFrame
    e = _engine()
    seen = []
    e.on_frame = seen.append
    fr = DecodedFrame(frame_bytes=b"x", header=F.HeaderInfo(), cw_ok=[True])
    assert e._deliver(fr) == 1
    assert e.frames_received == 1 and seen == [fr]
    assert e._last_rx_complete_time > 0


def test_cox_disconnected_decodes_dqpsk_link_establishment():
    """A DISCONNECTED Cox receiver whose config sits at a coherent data
    mode must still decode the DQPSK R1/4 link-establishment frames the
    pre-negotiation TX always emits (modem_engine.cpp:148-151 "if
    disconnected, use DQPSK R1/4 (robust mode), not config's mode").
    Before the round-4 fix the decode candidates were only the
    current/previous data modes and a Cox CONNECT was undecodable."""
    tx = ModemEngine()
    tx.connect_waveform = WaveformMode.OFDM_COX  # pre-negotiation Cox TX
    frame = F.ConnectFrame.make_connect("W1AW", "VE3ABC", 0xFF, 0x00) \
        .serialize()
    audio = tx.transmit(frame)  # disconnected -> DQPSK R1/4 on the wire

    rx = ModemEngine()
    rx.set_waveform_mode(WaveformMode.OFDM_COX)
    assert not rx.connected
    assert rx.data_modulation == Modulation.QPSK  # coherent default
    sig = np.concatenate([np.zeros(2400, np.float32), audio,
                          np.zeros(4000, np.float32)])
    rng = np.random.default_rng(1)
    rx.feed_audio(sig + rng.normal(0, 0.01, len(sig)).astype(np.float32))
    got = []
    rx.on_frame = got.append
    assert rx.cox.try_once() == 1
    assert got and got[0].frame_bytes == frame
