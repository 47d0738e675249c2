"""Single-carrier DPSK as an OPERATING MODE through the product surface.

The reference constructs DPSKModulator/Demodulator in its engine
(modem_engine.cpp:55-56) and reconfigures them (modem_mode.cpp:117-118,
294-315) but never wires an RX path; BASELINE config #1 nonetheless names
the `ultra ptx | ultra prx` single-carrier DPSK loopback as a headline
workload.  These tests pin that surface: engine streaming loopback at the
125 bps preset, the -11 dB floor through the full engine path, speed-level
reconfiguration, and the CLI pipe.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from projectultra.modem.engine import ModemEngine
from projectultra.protocol import frame_v2 as F
from projectultra.protocol.frame_v2 import WaveformMode
from projectultra.psk import dpsk as DP
from projectultra.sim import watterson as W


def _dpsk_engines():
    tx, rx = ModemEngine(), ModemEngine()
    for m in (tx, rx):
        m.set_waveform_mode(WaveformMode.DPSK)
        m.connect_waveform = WaveformMode.DPSK
    return tx, rx


def test_dpsk_loopback_streaming_125bps():
    """DATA frame at the medium preset (DQPSK 62.5 bd = raw 125 bps), fed in
    960-sample chunks with a poll per chunk (the audio-thread cadence)."""
    tx, rx = _dpsk_engines()
    assert tx.dpsk_config == DP.medium()  # 125 bps default
    frame = F.DataFrame.make_data("AA1AA", "BB2BB", 1, "dpsk 125bps").serialize()
    audio = tx.transmit(frame)

    got = []
    rx.on_frame = got.append
    for i in range(0, len(audio), 960):
        rx.feed_audio(audio[i:i + 960])
        rx.poll()
    rx.poll()

    assert len(got) == 1
    fr = got[0]
    assert fr.waveform == WaveformMode.DPSK
    df = F.DataFrame.deserialize(fr.frame_bytes)
    assert df and df.payload_as_text() == "dpsk 125bps"
    assert fr.snr_db > 20.0       # clean loopback
    assert abs(fr.cfo_hz) < 0.5


def test_dpsk_loopback_minus11db_floor():
    """BASELINE config #1 floor: the robust preset (DBPSK 31.25 bd) decoding
    a frame at -11 dB AWGN through the full engine path (real preamble
    search, CW0 probe, R1/4)."""
    tx, rx = _dpsk_engines()
    for m in (tx, rx):
        m.set_dpsk_speed_level(0)  # robust: the -11 dB preset
    frame = F.ControlFrame.make_ack("AA1AA", "BB2BB", 7).serialize()
    audio = tx.transmit(frame)
    noisy = np.asarray(W.add_noise_active(
        jax.random.PRNGKey(11), jnp.asarray(audio[None, :]), -11.0))[0]

    got = []
    rx.on_frame = got.append
    rx.feed_audio(noisy)   # prx-style: feed everything, then poll
    rx.poll()

    assert len(got) == 1
    fr = got[0]
    assert fr.waveform == WaveformMode.DPSK
    ctrl = F.ControlFrame.deserialize(fr.frame_bytes)
    assert ctrl is not None and ctrl.seq == 7


def test_dpsk_speed_levels_reconfigure():
    """set_dpsk_mode / set_dpsk_speed_level parity with setDPSKMode
    (modem_mode.cpp:294-315): loopback at a non-default preset."""
    tx, rx = _dpsk_engines()
    for m in (tx, rx):
        m.set_dpsk_mode(DP.DPSKModulation.DQPSK, 384)  # fast preset
        assert m.dpsk_config == DP.fast()
    frame = F.ControlFrame.make_ack("AA1AA", "BB2BB", 3).serialize()
    audio = tx.transmit(frame)
    got = []
    rx.on_frame = got.append
    rx.feed_audio(audio)
    rx.poll()
    assert len(got) == 1
    assert F.ControlFrame.deserialize(got[0].frame_bytes).seq == 3


def test_dpsk_ping_still_detected():
    """With the engine in DPSK mode, a chirp PING must still fall through to
    the chirp detector (acquisition runs both, modem_rx.cpp:38-146)."""
    tx, rx = _dpsk_engines()
    pings = []
    rx.on_ping = pings.append
    rx.feed_audio(tx.transmit_ping())
    rx.feed_audio(np.zeros(8000, np.float32))
    rx.poll()
    assert len(pings) == 1


def test_cli_dpsk_pipe_loopback():
    """`ultra ptx -w dpsk | ultra prx -w dpsk` (BASELINE config #1 surface)."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    tx = subprocess.run(
        [sys.executable, "-m", "projectultra.cli", "ptx", "cli dpsk",
         "-s", "AA1AA", "-d", "BB2BB", "-w", "dpsk"],
        capture_output=True, env=env, cwd=repo, timeout=600)
    assert tx.returncode == 0, tx.stderr.decode()[-2000:]
    assert len(tx.stdout) > 0
    rx = subprocess.run(
        [sys.executable, "-m", "projectultra.cli", "prx", "-w", "dpsk"],
        input=tx.stdout, capture_output=True, env=env, cwd=repo, timeout=600)
    assert rx.returncode == 0, rx.stderr.decode()[-2000:]
    err = rx.stderr.decode()
    assert "cli dpsk" in err
    assert "Frames: 1" in err


def test_two_dpsk_frames_in_one_feed():
    """Two frames fed in ONE buffer must BOTH decode, earliest first
    (review findings: global-argmax selection could lock onto the later
    frame; the consume-through then destroyed the earlier one)."""
    tx, rx = _dpsk_engines()
    for m in (tx, rx):
        m.set_dpsk_speed_level(3)  # fast preset keeps the test quick
    a1 = tx.transmit(F.ControlFrame.make_ack("AA1AA", "BB2BB", 1).serialize())
    a2 = tx.transmit(F.ControlFrame.make_ack("AA1AA", "BB2BB", 2).serialize())
    audio = np.concatenate([a1, np.zeros(2000, np.float32), a2,
                            np.zeros(8000, np.float32)])
    got = []
    rx.on_frame = got.append
    rx.feed_audio(audio)
    rx.poll()
    seqs = [F.ControlFrame.deserialize(fr.frame_bytes).seq for fr in got]
    assert seqs == [1, 2]


def test_earliest_preamble_wins_over_stronger_later():
    """find_preamble must pick the EARLIEST qualifying preamble even when a
    later one scores marginally higher (chirp detector rule)."""
    cfg = DP.fast()
    pre = DP.generate_preamble(cfg)
    buf = np.zeros(80000, np.float32)
    buf[3000:3000 + len(pre)] = 0.6 * pre   # earlier, weaker
    buf[45000:45000 + len(pre)] = pre       # later, stronger
    found, ds, *_ = DP.find_preamble(cfg, jnp.asarray(buf[None, :]))
    assert bool(np.asarray(found)[0])
    assert abs(int(np.asarray(ds)[0]) - (3000 + len(pre))) < cfg.samples_per_symbol


def test_dpsk_frame_deep_in_long_recording():
    """A frame starting beyond the bounded 262k-sample search span must
    still decode when fed with the RX poll cadence (review finding: one
    post-EOF poll left everything past the first search span unexamined;
    cli.run_prx now polls every ~100 ms of audio while feeding)."""
    tx, rx = _dpsk_engines()
    audio = tx.transmit(F.ControlFrame.make_ack("AA1AA", "BB2BB", 9).serialize())
    rng = np.random.default_rng(0)
    lead = rng.normal(0, 0.003, 48000 * 6).astype(np.float32)  # > search span
    stream = np.concatenate([lead, audio, np.zeros(8000, np.float32)])

    got = []
    rx.on_frame = got.append
    total = 0
    for i in range(0, len(stream), 960):
        rx.feed_audio(stream[i:i + 960])
        total += 960
        if total % 4800 < 960:
            rx.poll()
    rx.poll()
    assert len(got) == 1
    assert F.ControlFrame.deserialize(got[0].frame_bytes).seq == 9
    # The cleared-region trims must have kept the buffer bounded.
    assert len(rx._rx_buffer) < 200000


def test_weak_faded_early_preamble_found():
    """ADVICE r2: a genuinely weak (faded) early preamble sitting below 85%
    of a later stronger one must still win (earliest-frame semantics).  At
    this operating point the early peak scores ~0.82 — above the absolute
    0.80 gate but below 0.85*gmax (~0.847), so the round-2 relative-only
    rule skipped it and the engine's consume-through destroyed the frame."""
    cfg = DP.fast()
    pre = DP.generate_preamble(cfg)
    rng = np.random.default_rng(5)
    buf = rng.normal(0, 1.0, 80000).astype(np.float32)
    buf[3000:3000 + len(pre)] += 0.13 * pre   # faded early frame
    buf[45000:45000 + len(pre)] += 1.0 * pre  # strong later frame
    found, ds, *_ = DP.find_preamble(cfg, jnp.asarray(buf[None, :]))
    assert bool(np.asarray(found)[0])
    assert abs(int(np.asarray(ds)[0]) - (3000 + len(pre))) < cfg.samples_per_symbol


def test_dpsk_wait_preemption_on_cut_frame():
    """ADVICE r2: a multi-codeword DPSK frame cut after CW0 and followed by
    a NEW frame must not wedge the receiver — the wait tick must spot the
    new preamble in later audio, drop the cut frame, and decode the new one
    (the Cox path's mid-frame preemption, _cox_wait_tick)."""
    tx, rx = _dpsk_engines()
    for m in (tx, rx):
        m.set_dpsk_speed_level(3)  # fast preset keeps the test quick
    big = F.DataFrame.make_data("AA1AA", "BB2BB", 1, "x" * 120).serialize()
    cut_audio = tx.transmit(big)
    cfg = rx.dpsk_config
    L, bc = cfg.samples_per_symbol, cfg.bits_per_symbol
    cw0_syms = -(-F.LDPC_CODEWORD_BITS // bc)
    # Keep preamble + CW0 + two extra symbols, cut the rest mid-frame.
    keep = cfg.preamble_samples + (cw0_syms + 2) * L
    assert keep < len(cut_audio)  # must really be multi-codeword
    follow = tx.transmit(F.ControlFrame.make_ack("AA1AA", "BB2BB", 4).serialize())
    stream = np.concatenate([cut_audio[:keep], follow,
                             np.zeros(8000, np.float32)])
    got = []
    rx.on_frame = got.append
    for i in range(0, len(stream), 960):
        rx.feed_audio(stream[i:i + 960])
        rx.poll()
    rx.poll()
    seqs = [F.ControlFrame.deserialize(fr.frame_bytes).seq for fr in got
            if F.ControlFrame.deserialize(fr.frame_bytes) is not None]
    assert 4 in seqs


def test_reset_rx_clears_acquisition_state():
    """ModemEngine.reset_rx owns the full acquisition-state list (ADVICE r2:
    RxPipeline.reset previously reached into five private fields and missed
    two); a fresh frame decodes normally after a mid-frame reset."""
    tx, rx = _dpsk_engines()
    frame = F.ControlFrame.make_ack("AA1AA", "BB2BB", 5).serialize()
    audio = tx.transmit(frame)
    rx.feed_audio(audio[:len(audio) // 2])  # half a frame
    rx.poll()
    rx.reset_rx()
    assert len(rx._rx_buffer) == 0 and rx._rx_consumed == 0
    assert rx._dpsk_pending is None and rx._dpsk_wait is None
    assert rx._chirp_last_key is None and rx._cox_wait is None
    assert rx._dpsk_searched_until == 0 and rx._dpsk_clean_until == 0
    got = []
    rx.on_frame = got.append
    rx.feed_audio(audio)
    rx.poll()
    assert len(got) == 1
    assert F.ControlFrame.deserialize(got[0].frame_bytes).seq == 5


def test_mode_change_rearms_chirp_search():
    """ADVICE r2: the identical-state chirp memoization must not survive a
    waveform/DPSK-mode change over an unchanged buffer."""
    _, rx = _dpsk_engines()
    rx.feed_audio(np.zeros(200000, np.float32))
    rx.poll()
    assert rx._chirp_last_key is not None
    rx.set_dpsk_speed_level(0)
    assert rx._chirp_last_key is None
    rx.poll()
    assert rx._chirp_last_key is not None
    rx.set_waveform_mode(WaveformMode.OFDM_CHIRP)
    assert rx._chirp_last_key is None
