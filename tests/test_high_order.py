"""Beyond-reference high-order OFDM_COX data modes on the engine profile.

The 512-FFT carrier plan's DC-adjacent carriers carry a deterministic,
payload-dependent ICI floor (~-25 dB EVM on the worst 3 of 15 carriers —
see ofdm/demodulator._scan_data_symbols' high-order noise pass), so the
rates whose reference H construction leaves info bits parity-free (R3/4,
R5/6 — fec/ldpc.build_h_rows saturates the check-edge slots early) can
corrupt at ANY SNR and are excluded from the negotiation ladder
(modem/adaptive.CalibratedAdaptiveController.HIGH_TABLE).  The fully
protected R2/3 rows below are the ladder and must decode reliably with
random payloads; envelopes measured by tools/calibrate_mode_table.py
(QAM64 R2/3 clean from 22 dB AWGN, QAM256 R2/3 from 28 dB).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from projectultra.config import Modulation, CodeRate
from projectultra.modem.engine import ModemEngine
from projectultra.protocol import frame_v2 as F
from projectultra.protocol.frame_v2 import WaveformMode
from projectultra.sim import watterson as W


def _loopback(mod: Modulation, rate: CodeRate, snr_db: float,
              trial: int, config=None) -> bool:
    rng = np.random.default_rng(4200 + trial)
    payload = bytes(rng.integers(0, 256, 80, dtype=np.uint8))
    tx = ModemEngine() if config is None else ModemEngine(config=config)
    rx = ModemEngine() if config is None else ModemEngine(config=config)
    for m in (tx, rx):
        m.set_waveform_mode(WaveformMode.OFDM_COX)
        m.connect_waveform = WaveformMode.OFDM_COX
        m.connected = True
        m.handshake_complete = True
        m.data_modulation = mod
        m.data_code_rate = rate
    frame = F.DataFrame.make_data("AA1AA", "BB2BB", trial, payload).serialize()
    audio = tx.transmit(frame)
    a = jnp.asarray(np.concatenate(
        [np.zeros(2400, np.float32), audio,
         np.zeros(4000, np.float32)])[None, :])
    key = jax.random.fold_in(jax.random.PRNGKey(97), 131 * trial)
    noisy = W.add_noise_active(key, a, snr_db)
    got = []
    rx.on_frame = got.append
    rx.feed_audio(np.asarray(noisy)[0])
    rx.poll()
    return bool(got) and got[0].frame_bytes == frame


@pytest.mark.parametrize("mod,rate,snr", [
    (Modulation.QAM64, CodeRate.R2_3, 24.0),
    (Modulation.QAM256, CodeRate.R2_3, 30.0),
])
def test_high_order_r23_random_payload(mod, rate, snr):
    """Full streaming acquisition + decode at the HIGH_TABLE thresholds,
    random payloads (the ICI floor is payload-dependent — fixed payloads
    hide it)."""
    oks = [_loopback(mod, rate, snr, t) for t in range(3)]
    assert all(oks), oks


def test_qam256_r23_zero_noise_exact():
    """The deterministic ICI floor alone (no noise) must never corrupt a
    fully-protected R2/3 frame."""
    assert _loopback(Modulation.QAM256, CodeRate.R2_3, 80.0, 7)


@pytest.mark.parametrize("mod,rate,snr", [
    (Modulation.QAM64, CodeRate.R5_6, 20.0),
    (Modulation.QAM256, CodeRate.R2_3, 26.0),
])
def test_nvis_high_order_ladder_thresholds(mod, rate, snr):
    """NVIS 1024-profile ladder rows at their NVIS_HIGH_TABLE thresholds,
    random payloads through the full streaming engine (10/10 measured at
    these points on 400-byte frames; R5/6's parity-free info bits are safe
    on this profile's ~-32 dB EVM floor at QAM64 density — QAM256 R5/6
    keeps a ~10% ARQ-recovered long-frame residual and is asserted by the
    session test instead)."""
    from projectultra.config import nvis_mode
    oks = [_loopback(mod, rate, snr, t, config=nvis_mode())
           for t in range(3)]
    assert all(oks), oks


def test_nvis_profile_selects_nvis_high_table():
    """high_order_table routes the 1024-FFT no-pilot profile to the NVIS
    ladder (top row QAM256 R5/6) and every pilot profile to the
    conservative 512 ladder."""
    from projectultra.config import nvis_mode, high_throughput, ModemConfig
    from projectultra.modem.adaptive import (
        CalibratedAdaptiveController, high_order_table)
    assert high_order_table(nvis_mode()) \
        is CalibratedAdaptiveController.NVIS_HIGH_TABLE
    assert high_order_table(ModemConfig()) \
        is CalibratedAdaptiveController.HIGH_TABLE
    # 1024 WITH pilots is unmeasured -> conservative ladder.
    assert high_order_table(high_throughput()) \
        is CalibratedAdaptiveController.HIGH_TABLE

    c = CalibratedAdaptiveController(
        high_table=CalibratedAdaptiveController.NVIS_HIGH_TABLE)
    for _ in range(20):
        c.update(34.0, 0.2)
    assert (c.current_mod, c.current_rate) == \
        (Modulation.QAM256, CodeRate.R5_6)
    c = CalibratedAdaptiveController(
        high_table=CalibratedAdaptiveController.NVIS_HIGH_TABLE)
    for _ in range(20):
        c.update(22.0, 0.2)
    assert (c.current_mod, c.current_rate) == \
        (Modulation.QAM64, CodeRate.R5_6)


def _long_loopback(mod, rate, snr_db, trial, config=None, nbytes=400):
    """400-byte (file-chunk class) random-payload engine loopback: long
    frames expose ~5x the parity-free info bits of the 80-byte calibration
    frames and are the regime where both round-3 walls appeared (silent
    R3/4 corruption, 4-cycle trapping-set livelock)."""
    rng = np.random.default_rng(52000 + 37 * trial)
    payload = bytes(rng.integers(0, 256, nbytes, dtype=np.uint8))
    tx = ModemEngine() if config is None else ModemEngine(config=config)
    rx = ModemEngine() if config is None else ModemEngine(config=config)
    for m in (tx, rx):
        m.set_waveform_mode(WaveformMode.OFDM_COX)
        m.connect_waveform = WaveformMode.OFDM_COX
        m.connected = True
        m.handshake_complete = True
        m.data_modulation = mod
        m.data_code_rate = rate
    frame = F.DataFrame.make_data("AA1AA", "BB2BB", trial, payload).serialize()
    audio = tx.transmit(frame)
    a = jnp.asarray(np.concatenate(
        [np.zeros(2400, np.float32), audio,
         np.zeros(4000, np.float32)])[None, :])
    key = jax.random.fold_in(jax.random.PRNGKey(77),
                             1000 * trial + int(snr_db * 7))
    noisy = W.add_noise_active(key, a, snr_db)
    got = []
    rx.on_frame = got.append
    rx.feed_audio(np.asarray(noisy)[0])
    rx.poll()
    return bool(got) and got[0].frame_bytes == frame


def test_qam256_long_frame_trapping_payload():
    """Pinned regression: this exact payload (trial 5) produced two
    confident wrong bits on a 4-cycle pair of the R2/3 H — plain min-sum
    oscillates for 50 iterations at ANY SNR (measured NODET at 80 dB; an
    ARQ livelock since the retransmitted payload fails identically).  The
    frame path's trap_escape decode (ops/ldpc.decode) must recover it."""
    assert _long_loopback(Modulation.QAM256, CodeRate.R2_3, 34.0, 5)
    assert _long_loopback(Modulation.QAM256, CodeRate.R2_3, 60.0, 5)


def _trial5_cw0_llrs():
    """Deinterleaved CW0 LLRs of the trial-5 400-byte QAM256 R2/3 frame —
    the measured in-field trapping-set input: 2 confident wrong signs
    whose bits share two checks of the R2/3 H, which plain min-sum
    oscillates on for the full 50 iterations at any SNR."""
    from projectultra.config import bits_per_symbol
    from projectultra.ofdm import demodulator as D, pipeline as P
    from projectultra.fec.interleave import channel_interleaver
    from projectultra.config import ModemConfig

    mod, rate = Modulation.QAM256, CodeRate.R2_3
    rng = np.random.default_rng(52000 + 37 * 5)
    payload = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
    tx = ModemEngine()
    tx.set_waveform_mode(WaveformMode.OFDM_COX)
    tx.connect_waveform = WaveformMode.OFDM_COX
    tx.connected = True
    tx.handshake_complete = True
    tx.data_modulation = mod
    tx.data_code_rate = rate
    frame = F.DataFrame.make_data("AA1AA", "BB2BB", 5, payload).serialize()
    audio = tx.transmit(frame)
    a = np.concatenate([np.zeros(2400, np.float32), audio,
                        np.zeros(4000, np.float32)])
    cfg = ModemConfig()
    plen = cfg.fft_size + cfg.cyclic_prefix
    lts, S = 12400, 6
    need = lts + 2 * plen + S * cfg.symbol_duration
    span = jnp.asarray(a[None, lts - 2 * plen:need + 2 * plen])
    llrs, _ = D.demodulate_span(cfg, mod, span, -0.158, 0.0,
                                n_lts=2, S=S, lead=2 * plen, tail=2 * plen)
    l = np.asarray(llrs)[0][:648]
    ci = channel_interleaver(15 * bits_per_symbol(mod), 648)
    return ci.deinterleave_soft(l)


def test_ldpc_trap_escape_rescues_field_case():
    """Decoder-level regression on the measured in-field trapping input:
    plain min-sum must fail it (documenting the reference decoder's
    limitation — lane parity) and trap_escape must rescue it, leaving a
    converged sibling lane bit-identical."""
    from projectultra.fec.ldpc import get_code
    from projectultra.ops import ldpc as ldpc_ops

    code = get_code(CodeRate.R2_3)
    ld = _trial5_cw0_llrs()
    clean = np.full(648, 10.0, np.float32)  # all-zeros codeword, trivial
    batch = jnp.asarray(np.stack([ld, clean]))

    out0, ok0, _ = ldpc_ops.decode(code, batch)
    assert not bool(np.asarray(ok0)[0]), "expected the trapping input to fail"
    assert bool(np.asarray(ok0)[1])

    out1, ok1, _ = ldpc_ops.decode(code, batch, trap_escape=True)
    assert bool(np.asarray(ok1)[0]), "trap_escape must rescue the field case"
    assert bool(np.asarray(ok1)[1])
    # Converged lanes keep lane-exact parity with the plain decode.
    assert (np.asarray(out1)[1] == np.asarray(out0)[1]).all()


def test_calibrated_table_excludes_parity_free_rates():
    """The calibrated main table and the 512 flat-gated ladder must never
    contain R3/4 or R5/6: their parity-free info bits (fec/ldpc
    build_h_rows saturates check slots early) corrupt LONG frames on the
    512 plan's deterministic ICI floor at any SNR — measured 6-7/10
    corrupted 400-byte QAM16 R3/4 frames at 80 dB, an ARQ livelock the
    frame CRC detects but cannot fix."""
    from projectultra.modem.adaptive import CalibratedAdaptiveController
    bad = (CodeRate.R3_4, CodeRate.R5_6)
    for thresh, mod, rate in (CalibratedAdaptiveController.TABLE
                              + CalibratedAdaptiveController.HIGH_TABLE):
        assert rate not in bad, (mod, rate)


def test_qam16_r23_long_frame_clean():
    """The calibrated non-flat ceiling (QAM16 R2/3) must carry file-chunk
    frames clean at its 20 dB threshold."""
    oks = [_long_loopback(Modulation.QAM16, CodeRate.R2_3, 20.0, t)
           for t in range(3)]
    assert all(oks), oks


def test_real_front_qam16_r34_exact_at_zero_cfo():
    """Real-passband front-end regression (engine REAL_FRONT_CFO_MAX_HZ):
    at ~zero CFO the engine demodulates coherent pilot-plan frames from
    the RAW real passband (the conjugate image is bin-orthogonal — the
    reference demod's own front-end, measured ZERO sign errors at zero
    noise), so QAM16 R3/4 long frames decode clean where the analytic
    Hilbert front's DC-adjacent mask leakage corrupted 60-70% of them at
    ANY SNR.  R3/4 stays out of the negotiation tables because a true
    CFO above the crossover falls back to the analytic front where its
    parity-free bits corrupt again."""
    oks = [_long_loopback(Modulation.QAM16, CodeRate.R3_4, 26.0, t)
           for t in range(4)]
    assert all(oks), oks
    assert _long_loopback(Modulation.QAM16, CodeRate.R3_4, 80.0, 1)


def test_exact_ladder_requires_flat_and_low_cfo():
    """The 512 exact ladder (real-front R5/6 rows) needs BOTH sustained
    flat evidence AND sustained low-CFO evidence; losing either closes
    it back to the R2/3 ladder."""
    from projectultra.modem.adaptive import (
        CalibratedAdaptiveController, exact_order_table)
    from projectultra.config import ModemConfig, nvis_mode

    assert exact_order_table(ModemConfig()) \
        == CalibratedAdaptiveController.EXACT_TABLE
    assert exact_order_table(nvis_mode()) == []

    mk = lambda: CalibratedAdaptiveController(
        exact_table=CalibratedAdaptiveController.EXACT_TABLE)
    # Flat + low CFO: climbs to QAM256 R5/6 at 32 dB.
    c = mk()
    for _ in range(20):
        c.update(32.0, 0.2, cfo_hz=0.3)
    assert (c.current_mod, c.current_rate) == \
        (Modulation.QAM256, CodeRate.R5_6)
    # Flat but CFO beyond the gate: stops at the R2/3 ladder.
    c = mk()
    for _ in range(20):
        c.update(32.0, 0.2, cfo_hz=3.0)
    assert (c.current_mod, c.current_rate) == \
        (Modulation.QAM256, CodeRate.R2_3)
    # CFO drifting out mid-session closes the exact rows again.
    c = mk()
    for _ in range(20):
        c.update(32.0, 0.2, cfo_hz=0.3)
    for _ in range(10):
        c.update(32.0, 0.2, cfo_hz=4.0)
    assert (c.current_mod, c.current_rate) == \
        (Modulation.QAM256, CodeRate.R2_3)


def test_512_session_negotiates_qam256_r56_exact_ladder():
    """Default-profile (512 pilot plan) session at 32 dB flat AWGN with
    ~0 CFO: the exact ladder carries auto-negotiation to QAM256 R5/6 —
    a rank the analytic ICI floor made impossible on this plan."""
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.protocol.frame_v2 import WaveformMode as WM
    from projectultra.sim import watterson as W

    true_snr = 32.0
    key = jax.random.PRNGKey(21)
    counter = [0]

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        k = jax.random.fold_in(key, counter[0])
        return np.asarray(W.add_noise_active(k, a, true_snr))[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    for e in (a, b):
        e.connection.config.calibrated_snr = True
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(true_snr)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append
    assert a.connect("VE3ABC")
    assert b.connection.negotiated_mode == WM.OFDM_COX

    n = 14
    ia = ib = 0
    for _ in range(300):
        if ia < n and a.send_message(f"a{ia:02d}"):
            ia += 1
        if ib < n and b.send_message(f"b{ib:02d}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if (ia >= n and ib >= n
                and len(got_a) >= n and len(got_b) >= n):
            break
    assert got_b == [f"a{i:02d}" for i in range(n)]
    assert got_a == [f"b{i:02d}" for i in range(n)]
    assert (a.modem.data_modulation, a.modem.data_code_rate) == \
        (Modulation.QAM256, CodeRate.R5_6)


def test_one_way_transfer_downgrades_when_fading_develops():
    """A one-way file transfer (the sender hears only ACKs) must not
    freeze at a high-order mode when fading develops mid-transfer: the
    downgrade-only control-reading path (adaptive.observe_control) is
    the only feedback and has to close the gate."""
    from projectultra.config import nvis_mode
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W
    from projectultra.config import bits_per_symbol, code_rate_value

    key = jax.random.PRNGKey(11)
    counter = [0]
    state = {"snr": 34.0, "fade": False}

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        k = jax.random.fold_in(key, counter[0])
        if state["fade"]:
            a = W.watterson(k, a, W.PRESETS["moderate"](state["snr"]))
        else:
            a = W.add_noise_active(k, a, state["snr"])
        return np.asarray(a)[0]

    a = ProtocolEngine(ModemEngine(config=nvis_mode()))
    b = ProtocolEngine(ModemEngine(config=nvis_mode()))
    for e in (a, b):
        e.connection.config.calibrated_snr = True
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(34.0)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append
    assert a.connect("VE3ABC")

    # Climb into the ladder on clean readings.
    ia = ib = 0
    for _ in range(300):
        if ia < 14 and a.send_message(f"a{ia:02d}"):
            ia += 1
        if ib < 14 and b.send_message(f"b{ib:02d}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if ia >= 14 and ib >= 14 and len(got_a) >= 14 and len(got_b) >= 14:
            break
    rank0 = bits_per_symbol(a.modem.data_modulation) * code_rate_value(
        a.modem.data_code_rate)
    assert rank0 > 4.0, "session should be in the high-order ladder"

    # Fading develops at a level where ROBUST control frames still
    # decode (Cox under fading needs ~19+ dB true) but the high-order
    # fade envelope has collapsed; a one-way transfer starts (only ACKs
    # flow back).  Harsher fades kill ALL feedback and are a keepalive/
    # disconnect scenario, not an adaptation one.
    state["snr"], state["fade"] = 22.0, True
    import tempfile, os
    rng = np.random.default_rng(9)
    tmpdir = tempfile.mkdtemp()
    src = os.path.join(tmpdir, "oneway.bin")
    with open(src, "wb") as f:
        f.write(rng.integers(0, 256, 2000, dtype=np.uint8).tobytes())
    assert a.connection.send_file(src)
    for _ in range(60):
        a.tick(5000)
        b.tick(5000)
        rank = bits_per_symbol(a.modem.data_modulation) * code_rate_value(
            a.modem.data_code_rate)
        if rank <= 4.0:
            break
    rank = bits_per_symbol(a.modem.data_modulation) * code_rate_value(
        a.modem.data_code_rate)
    assert rank <= 4.0, \
        f"mode froze at {a.modem.data_modulation.name}/" \
        f"{a.modem.data_code_rate.name} under developed fading"


def test_wideband_snr_survives_guarded_consume():
    """Estimator regression: on the NVIS profile the 1024 Cox search
    false-positives on the frame's own chirp preamble, fails decode, and
    the guarded fail-consume (engine._try_cox_once) lands the buffer
    start samples ahead of the chirp — the noise window before the frame
    is starved and the estimator must pool the audio AFTER the frame
    instead of falling back to the (mostly signal) whole snapshot, which
    read 34 dB frames at ~6 dB and parked negotiation on MC_DPSK."""
    from projectultra.config import nvis_mode
    from projectultra.sim import watterson as W

    tx, rx = ModemEngine(config=nvis_mode()), ModemEngine(config=nvis_mode())
    fr = F.DataFrame.make_data("AA1AA", "BB2BB", 1,
                               b"hello world " * 4).serialize()
    audio = tx.transmit(fr)
    a = jnp.asarray(np.concatenate(
        [np.zeros(2000, np.float32), audio,
         np.zeros(4000, np.float32)])[None, :])
    noisy = W.add_noise_active(jax.random.PRNGKey(5), a, 34.0)
    got = []
    rx.on_frame = got.append
    rx.feed_audio(np.asarray(noisy)[0])
    rx.poll()
    assert got and got[0].frame_bytes == fr
    assert got[0].wideband_snr_db > 30.0, got[0].wideband_snr_db


def test_nvis_session_negotiates_qam256_r56():
    """Full two-station over-the-air session on the NVIS profile at 34 dB
    flat AWGN: calibrated negotiation must pick OFDM_COX at connect and
    the flat-gated NVIS ladder must climb the data mode to QAM256 R5/6
    (12.7 kbps over-the-air class) with every message delivered — the
    beyond-reference throughput path end to end."""
    from projectultra.config import nvis_mode
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.protocol.frame_v2 import WaveformMode as WM
    from projectultra.sim import watterson as W

    true_snr = 34.0
    key = jax.random.PRNGKey(42)
    counter = [0]

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        k = jax.random.fold_in(key, counter[0])
        return np.asarray(W.add_noise_active(k, a, true_snr))[0]

    a = ProtocolEngine(ModemEngine(config=nvis_mode()))
    b = ProtocolEngine(ModemEngine(config=nvis_mode()))
    for e in (a, b):
        e.connection.config.calibrated_snr = True
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(true_snr)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append

    assert a.connect("VE3ABC")
    assert b.connection.negotiated_mode == WM.OFDM_COX

    # >= 14 data frames each way: control-frame readings are excluded
    # from negotiation (their DBPSK scale reads hot — see
    # ProtocolEngine._on_modem_frame), so the flat gate (6-reading
    # window + 3 flat frames) plus the 4-recommendation upgrade
    # debounce needs ~13 DATA readings.
    n = 14
    ia = ib = 0
    for _ in range(300):
        if ia < n and a.send_message(f"a{ia:02d}"):
            ia += 1
        if ib < n and b.send_message(f"b{ib:02d}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if (ia >= n and ib >= n
                and len(got_a) >= n and len(got_b) >= n):
            break
    assert got_b == [f"a{i:02d}" for i in range(n)]
    assert got_a == [f"b{i:02d}" for i in range(n)]
    assert (a.modem.data_modulation, a.modem.data_code_rate) == \
        (Modulation.QAM256, CodeRate.R5_6)
    assert a.modem.waveform_mode == WM.OFDM_COX
