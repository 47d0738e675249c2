"""Adaptive narrowband excision (modem/excision.py, beyond-reference).

A persistent CW interferer at SIR 10 dB collapses streaming decode
without excision (measured round 4, docs/PERF.md); these tests pin the
detector's trigger envelope (tones yes, noise no, our own modulated
carriers NEVER) and the engine-level recovery.
"""

import os

import numpy as np
import pytest

from projectultra.config import Modulation, CodeRate
from projectultra.modem.excision import ToneExciser, notch_coef
from projectultra.native import biquad_cascade
from projectultra.protocol import frame_v2 as F
from projectultra.protocol.frame_v2 import WaveformMode

FS = 48000


def _feed(ex, x, chunk=960):
    out = []
    for i in range(0, len(x), chunk):
        out.append(ex.process(x[i:i + chunk]))
    return np.concatenate(out)


def test_notch_chunked_matches_oneshot():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.1, FS).astype(np.float32)
    coef = notch_coef(1500.0)[None, :]
    s1 = np.zeros((1, 2))
    s2 = np.zeros((1, 2))
    one = biquad_cascade(x, coef, s1)
    chunks = np.concatenate([biquad_cascade(x[i:i + 960], coef, s2)
                             for i in range(0, len(x), 960)])
    assert np.array_equal(one, chunks)


def test_tone_detected_and_suppressed():
    rng = np.random.default_rng(1)
    t = np.arange(FS * 5) / FS
    x = (0.05 * np.sin(2 * np.pi * 1500.0 * t)
         + rng.normal(0, 0.02, len(t))).astype(np.float32)
    ex = ToneExciser()
    y = _feed(ex, x)
    assert len(ex.active_tones) == 1
    assert abs(ex.active_tones[0] - 1500.0) < 10.0
    seg_in, seg_out = x[-FS:], y[-FS:]
    w = np.hanning(FS)
    b = int(round(1500.0))  # 1 Hz bins on a 1 s window
    pin = np.abs(np.fft.rfft(seg_in * w)[b]) ** 2
    pout = np.abs(np.fft.rfft(seg_out * w)[b]) ** 2
    assert 10 * np.log10(pout / pin) < -40.0


def test_no_trigger_on_noise():
    rng = np.random.default_rng(2)
    ex = ToneExciser()
    _feed(ex, rng.normal(0, 0.02, FS * 10).astype(np.float32))
    assert ex.quiet_updates >= 5
    assert ex.active_tones == []


def test_no_trigger_on_own_waveforms():
    """Adversarial self-notch check: CONTINUOUS 31.25-baud DBPSK (the
    narrowest shipped line, psk/dpsk.py robust) over mild noise, so the
    quiet gate passes on every update — the narrowness gate must reject
    the modulated carrier.  Same for an MC-DPSK frame stream."""
    from projectultra.psk import dpsk as DP
    rng = np.random.default_rng(3)
    cfg = DP.robust()
    bits = rng.integers(0, 2, (1, 600)).astype(np.float32)
    import jax.numpy as jnp
    burst = np.asarray(DP.modulate(cfg, jnp.asarray(bits)))[0]
    sig = np.tile(burst, max(1, int(FS * 22 / len(burst)) + 1))[:FS * 22]
    x = (sig + rng.normal(0, np.sqrt(np.mean(sig ** 2)) / 3, len(sig))
         ).astype(np.float32)
    ex = ToneExciser()
    _feed(ex, x)
    assert ex.quiet_updates >= 10  # the gate DID evaluate the burst
    assert ex.active_tones == []

    from projectultra.psk import mc_dpsk as MC
    mc = MC.level10()
    cw = jnp.asarray(rng.integers(0, 2, (1, 648)).astype(np.float32))
    data = np.asarray(MC.modulate(mc, cw))[0]
    sig2 = np.tile(data, max(1, int(FS * 22 / len(data)) + 1))[:FS * 22]
    x2 = (sig2 + rng.normal(0, np.sqrt(np.mean(sig2 ** 2)) / 3, len(sig2))
          ).astype(np.float32)
    ex2 = ToneExciser()
    _feed(ex2, x2)
    assert ex2.active_tones == []


@pytest.mark.parametrize("sir_db,tone_hz", [(5.0, 1500.0), (0.0, 800.0)])
def test_engine_decodes_through_cw_tone(sir_db, tone_hz):
    """OFDM_COX frame behind a co-channel CW tone: 0/3 decodes without
    excision at these operating points (docs/PERF.md round 4); with the
    exciser engaged during the noise lead the frame must decode."""
    from projectultra.modem.engine import ModemEngine
    rng = np.random.default_rng(int(sir_db) + 7)

    def make(wf):
        e = ModemEngine()
        e.set_waveform_mode(wf)
        e.connect_waveform = wf
        e.connected = True
        e.handshake_complete = True
        e.data_modulation = Modulation.DQPSK
        e.data_code_rate = CodeRate.R1_2
        return e

    tx = make(WaveformMode.OFDM_COX)
    fb = F.DataFrame.make_data("W1AW", "VE3ABC", 1, "TONE_SURVIVOR").serialize()
    audio = tx.transmit(fb)
    lead = int(3.5 * FS)
    stream = np.zeros(lead + len(audio) + FS, np.float32)
    stream[lead:lead + len(audio)] += audio
    sig_p = float(np.mean(audio ** 2))
    t = np.arange(len(stream)) / FS
    tone_p = sig_p / 10 ** (sir_db / 10.0)
    stream += np.sqrt(2 * tone_p) * np.sin(
        2 * np.pi * tone_hz * t).astype(np.float32)
    noise = np.sqrt(sig_p / 10 ** (20.0 / 10.0))
    stream += rng.normal(0, noise, len(stream)).astype(np.float32)

    rx = make(WaveformMode.OFDM_COX)
    got = []
    rx.on_frame = got.append
    fed = 0
    for i in range(0, len(stream), 960):
        rx.feed_audio(stream[i:i + 960])
        fed += 960
        if fed % 4800 < 960:
            rx.poll()
    rx.feed_audio(np.zeros(8000, np.float32))
    rx.poll()
    texts = [F.DataFrame.deserialize(fr.frame_bytes).payload_as_text()
             for fr in got if F.DataFrame.deserialize(fr.frame_bytes)]
    assert abs(rx.exciser.active_tones[0] - tone_hz) < 15.0
    assert "TONE_SURVIVOR" in texts



def test_mid_session_interferer_onset():
    """CW interferer switching ON in the MIDDLE of an active ARQ transfer
    (VERDICT r4 weak #2; full SIR sweep in tools/test_interferer_onset.py).
    Pins, at SIR 5 dB: (a) the floor STEP-UP re-anchors and the notch
    engages within 10 s of interferer-lit air (vs ~10 s floor ageing + 2
    confirmations without it); (b) every in-flight-corrupted message comes
    back via ARQ with the session alive; (c) the comb-rejection gate keeps
    the exciser from learning the frames' own spectrum as 'tones' (the
    first onset run activated 3 false carrier notches and livelocked)."""
    import importlib.util
    tool_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "test_interferer_onset.py")
    spec = importlib.util.spec_from_file_location("onset_tool", tool_path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    react, got, n, retx, false_tones, conn = tool.run_onset(5.0)
    assert got == n, f"delivered {got}/{n}"
    assert conn
    assert react is not None and react <= 10.0, f"time-to-notch {react}"
    assert false_tones == [], false_tones


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_mc_dpsk_tone_on_carrier(trial):
    """The round-4 excision matrix's single residual failure: a CW tone at
    SIR 5 sitting exactly ON an MC-DPSK carrier (1500 Hz is carrier 6 of
    level10).  The notch removes the tone AND that carrier's signal, whose
    differential decisions then demap as confident-wrong bits — one R1/2
    trial fell over.  Round 5 zeroes the straddled carrier's LLRs
    (acquisition/chirp.py notch-aware erasure) so the code treats the hole
    as parity-recoverable: all three seeds must now decode."""
    from projectultra.modem.engine import ModemEngine
    rng = np.random.default_rng(100 + trial)

    def make():
        e = ModemEngine()
        e.set_waveform_mode(WaveformMode.MC_DPSK)
        e.connect_waveform = WaveformMode.MC_DPSK
        e.connected = True
        e.handshake_complete = True
        e.data_modulation = Modulation.DQPSK
        e.data_code_rate = CodeRate.R1_2
        return e

    tx = make()
    fb = F.DataFrame.make_data("W1AW", "VE3ABC", 1,
                               f"ON_CARRIER_{trial}").serialize()
    audio = tx.transmit(fb)
    lead = int(3.5 * FS)
    stream = np.zeros(lead + len(audio) + FS, np.float32)
    stream[lead:lead + len(audio)] += audio
    sig_p = float(np.mean(audio ** 2))
    t = np.arange(len(stream)) / FS
    tone_p = sig_p / 10 ** (5.0 / 10.0)
    stream += np.sqrt(2 * tone_p) * np.sin(
        2 * np.pi * 1500.0 * t).astype(np.float32)
    stream += rng.normal(0, np.sqrt(sig_p / 10 ** 2.0),
                         len(stream)).astype(np.float32)

    rx = make()
    got = []
    rx.on_frame = got.append
    for i in range(0, len(stream), 960):
        rx.feed_audio(stream[i:i + 960])
        if i % 4800 < 960:
            rx.poll()
    rx.feed_audio(np.zeros(8000, np.float32))
    rx.poll()
    assert any(abs(f0 - 1500.0) < 15.0 for f0 in rx.exciser.active_tones)
    texts = [F.DataFrame.deserialize(fr.frame_bytes).payload_as_text()
             for fr in got if F.DataFrame.deserialize(fr.frame_bytes)]
    assert f"ON_CARRIER_{trial}" in texts


def test_no_trigger_on_dpsk_frame_preamble_comb():
    """Round-5 regression pin (the on-chip stream matrix catch): the robust
    DPSK frame PREAMBLE (Barker-13x3 DBPSK) is periodic and its spectrum
    shows discrete lines at 1500 +- 31.25k Hz, and the mostly-zero R1/4
    info section leaves the differential carrier quasi-TONAL (18-24 dB
    over the median at -11 dB under loud noise, measured).  The round-4
    detector notched the waveform's own carrier (stream matrix DPSK row
    100% -> 40%).  Spectral gates alone cannot separate that from a het,
    so the engine feeds the exciser its frame-in-the-air knowledge
    (ModemEngine._excision_rx_hints: activation deferred while a
    preamble/decode is pending; activations post-dating a detected
    frame's start revoked).  Both frames must decode and no notch may
    survive."""
    import jax
    import jax.numpy as jnp
    from projectultra.modem.engine import ModemEngine
    from projectultra.sim import watterson as W
    from projectultra.psk import dpsk as DP

    def eng():
        m = ModemEngine()
        m.set_waveform_mode(WaveformMode.DPSK)
        m.connected = True
        m.handshake_complete = True
        m.dpsk_config = DP.robust()
        return m

    tx = eng()
    pieces = []
    for i in range(2):
        fb = F.DataFrame.make_data("W1AW", "VE3ABC", i + 1,
                                   f"stream frame {i:02d}")
        pieces.append(tx.transmit(fb.serialize()))
        pieces.append(np.zeros(4800, np.float32))
    stream = np.concatenate([np.zeros(4800, np.float32)] + pieces
                            + [np.zeros(8000, np.float32)])
    noisy = np.asarray(W.add_noise_active(
        jax.random.PRNGKey(42), jnp.asarray(stream[None]), -11.0))[0]
    rx = eng()
    got = []
    rx.on_frame = got.append
    for n, i in enumerate(range(0, len(noisy), 960)):
        rx.feed_audio(noisy[i:i + 960].astype(np.float32))
        if n % 5 == 0:
            rx.poll()
    for _ in range(6):
        rx.poll()
    assert rx.exciser.quiet_updates >= 20
    assert rx.exciser.active_tones == []
    decoded = [F.DataFrame.deserialize(fr.frame_bytes) for fr in got
               if all(fr.cw_ok)]
    assert len([d for d in decoded if d is not None]) == 2, len(got)
