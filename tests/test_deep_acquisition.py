"""Deep (below-the-floor) Schmidl-Cox acquisition.

The reference gates the Schmidl-Cox plateau at 0.90
(demodulator_constants.hpp:51) and this rebuild's faithful default at 0.85
(sync/schmidl_cox.PLATEAU_THRESHOLD), which floors coherent OFDM_COX
acquisition at ~13-14 dB wideband AWGN even though the payload itself
decodes far lower.  Deep acquisition (a deliberate capability extension,
PARITY.md) evaluates a lowered gate set in the SAME detection dispatch and
believes a candidate only after its CW0 LDPC-decodes with a valid v2
header — extending the streaming floor to ~8 dB wideband with no false
decodes (the 10-minute noise soak in tools/test_hf_reality.py covers the
long-run false-positive property).
"""

import numpy as np
import pytest

from projectultra.config import CodeRate
from projectultra.modem.engine import ModemEngine
from projectultra.protocol import frame_v2 as F
from projectultra.protocol.frame_v2 import WaveformMode

MSG = "deep acquisition extends the cox floor below the plateau"


def _pair():
    tx, rx = ModemEngine(), ModemEngine()
    for m in (tx, rx):
        m.set_waveform_mode(WaveformMode.OFDM_COX)
        m.connected = True
        m.handshake_complete = True
        m.data_code_rate = CodeRate.R1_2
    return tx, rx


def _noisy_stream(seed: int, snr_db: float):
    rng = np.random.default_rng(seed)
    tx, rx = _pair()
    frame = F.DataFrame.make_data("W1AW", "VE3ABC", 1, MSG)
    audio = tx.transmit(frame.serialize())
    ps = float((audio ** 2).mean())
    sigma = np.sqrt(ps / 10 ** (snr_db / 10.0))
    sig = np.zeros(12000 + len(audio) + 9000, np.float32)
    sig[12000:12000 + len(audio)] = audio
    sig += rng.normal(0, sigma, len(sig)).astype(np.float32)
    return rx, sig


def _stream(rx, sig, chunk=960):
    got = []
    rx.on_frame = got.append
    for i in range(0, len(sig), chunk):
        rx.feed_audio(sig[i:i + chunk])
        rx.poll()
    rx.poll()
    return got


def test_deep_acquisition_decodes_at_9db_wideband():
    """6 dB below the faithful plateau floor, the stream still decodes."""
    hits = 0
    for seed in (11, 12, 13):
        rx, sig = _noisy_stream(seed, 9.0)
        got = _stream(rx, sig)
        hits += any(MSG.encode() in f.frame_bytes for f in got)
    assert hits >= 2, f"deep acquisition decoded only {hits}/3 at 9 dB"


def test_without_deep_the_floor_holds():
    """Ablation: the SAME streams are undecodable with deep acquisition
    off — proving the decodes above come from the deep gate set, not from
    the faithful path."""
    for seed in (11, 12, 13):
        rx, sig = _noisy_stream(seed, 9.0)
        rx.deep_acquisition = False
        got = _stream(rx, sig)
        assert not got, "faithful gates decoded at 9 dB — floor moved?"


def test_deep_candidate_on_noise_never_wedges_or_decodes():
    """Pure noise: no frames, no stuck pending state, and the buffer keeps
    being trimmed (deep candidates must stay speculative)."""
    rng = np.random.default_rng(99)
    _, rx = _pair()
    rx.on_frame = lambda f: pytest.fail("decoded a frame from pure noise")
    sig = rng.normal(0, 1.0, 48000 * 8).astype(np.float32)
    for i in range(0, len(sig), 960):
        rx.feed_audio(sig[i:i + 960])
        rx.poll()
    rx.poll()
    assert rx.frames_received == 0
    # The no-detect trims must keep running underneath any speculative
    # deep candidates: the retained buffer stays bounded.
    assert len(rx._rx_buffer) < 6 * 48000


def test_deep_frame_cut_mid_stream_releases_receiver():
    """A deep candidate whose stream dies mid-frame must time out and not
    block a later, complete frame."""
    rng = np.random.default_rng(5)
    tx, rx = _pair()
    f1 = F.DataFrame.make_data("W1AW", "VE3ABC", 1, "x" * 80)
    cut = tx.transmit(f1.serialize())
    cut = cut[:26000]  # past the preamble, before the data completes
    f2 = F.DataFrame.make_data("W1AW", "VE3ABC", 2, MSG)
    full = tx.transmit(f2.serialize())
    ps = float((full ** 2).mean())
    sigma = np.sqrt(ps / 10 ** (10.0 / 10.0))
    sig = np.concatenate([
        np.zeros(6000, np.float32), cut,
        np.zeros(30000, np.float32), full, np.zeros(9000, np.float32)])
    sig += rng.normal(0, sigma, len(sig)).astype(np.float32)
    got = _stream(rx, sig)
    assert any(MSG.encode() in f.frame_bytes for f in got), \
        "complete frame after a cut deep candidate was not decoded"
