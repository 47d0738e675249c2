"""Schmidl-Cox acquisition + full OFDM_COX streaming RX tests.

Reference behavior: ofdm_sync.cpp + demodulator.cpp SEARCHING path;
regression point: OFDM @ AWGN SNR>=17 dB decodes 100%.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from projectultra.config import ModemConfig, Modulation, CodeRate
from projectultra.fec import ldpc
from projectultra.fec.interleave import channel_interleaver
from projectultra.ofdm import modulator as M
from projectultra.ofdm import carriers as C
from projectultra.ops import ldpc as ldpc_ops
from projectultra.sync import schmidl_cox as SC
from projectultra.sim import watterson as W
from projectultra.config import bits_per_symbol

CFG = ModemConfig()  # default: 512 FFT, 30 carriers, pilots


def _make_tx(mod, rate, B, seed=0, interleave=True):
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    cw = np.asarray(ldpc_ops.encode(code, jnp.asarray(info)))
    if interleave:
        cm = C.carrier_map(CFG)
        ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod), 648)
        cw = cw[:, ci.inv]
    pre = M.generate_preamble(CFG)
    data = M.modulate(CFG, mod, jnp.asarray(cw),
                      t_offset=M.preamble_data_t_offset(CFG))
    lead = np.zeros(3000, np.float32)
    tx = jnp.concatenate([
        jnp.broadcast_to(jnp.asarray(np.concatenate([lead, pre])),
                         (B, len(lead) + len(pre))),
        data, jnp.zeros((B, 2000))], axis=-1)
    return info, tx, (len(lead), len(pre))


def test_detect_preamble_clean():
    _, tx, (lead_n, pre_n) = _make_tx(Modulation.QPSK, CodeRate.R1_2, B=2)
    det = {k: np.asarray(v) for k, v in SC.detect_preamble(CFG, tx).items()}
    assert det["found"].all()
    # STS starts after lead + silence guard symbol (N+CP).
    plen = CFG.fft_size + CFG.cyclic_prefix
    true_sts = 3000 + plen
    assert np.abs(det["sync_off"] - true_sts).max() <= 300  # within plateau
    true_lts = 3000 + 5 * plen
    assert np.abs(det["lts_start"] - true_lts).max() <= 2
    assert np.abs(det["cfo_hz"]).max() < 3.0


def test_detect_preamble_cfo_noise():
    _, tx, _ = _make_tx(Modulation.QPSK, CodeRate.R1_2, B=2)
    cfo = 40.0
    shifted = W.apply_cfo_hilbert(tx, jnp.full((2,), cfo))
    noisy = W.add_noise_active(jax.random.PRNGKey(0), shifted, 17.0)
    det = {k: np.asarray(v) for k, v in SC.detect_preamble(CFG, noisy).items()}
    assert det["found"].all()
    assert np.abs(det["cfo_hz"] - cfo).max() < 8.0
    plen = CFG.fft_size + CFG.cyclic_prefix
    assert np.abs(det["lts_start"] - (3000 + 5 * plen)).max() <= 4


def _cox_e2e(mod, rate, snr_db, cfo=0.0, B=4, seed=1):
    info, tx, _ = _make_tx(mod, rate, B=B, seed=seed)
    key = jax.random.PRNGKey(seed)
    if cfo:
        tx = W.apply_cfo_hilbert(tx, jnp.full((B,), cfo))
    rx_in = W.add_noise_active(key, tx, snr_db)
    llrs, det = SC.decode_ofdm_cox(CFG, mod, rx_in, 1)
    assert np.asarray(det["found"]).all()
    cm = C.carrier_map(CFG)
    ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod), 648)
    code = ldpc.get_code(rate)
    deint = np.asarray(llrs)[:, :648][:, ci.perm]
    out, ok, _ = ldpc_ops.decode(code, jnp.asarray(deint))
    match = (np.asarray(out) == info.astype(np.uint8)).all(-1)
    return np.asarray(ok), match


def test_cox_qpsk_awgn17():
    """OFDM QPSK R1/2 @17 dB with pilot tracking end-to-end."""
    ok, match = _cox_e2e(Modulation.QPSK, CodeRate.R1_2, 17.0)
    assert ok.all() and match.all()


def test_cox_qam16_awgn25():
    """Coherent 16QAM R2/3 @25 dB (NVIS-style throughput point)."""
    ok, match = _cox_e2e(Modulation.QAM16, CodeRate.R2_3, 25.0)
    assert ok.all() and match.all()


def test_cox_qpsk_cfo30():
    ok, match = _cox_e2e(Modulation.QPSK, CodeRate.R1_2, 20.0, cfo=30.0)
    assert ok.all() and match.all()


def test_no_false_positive_on_noise():
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (2, 40000)),
                       np.float32) * 0.1
    det = {k: np.asarray(v) for k, v in
           SC.detect_preamble(CFG, jnp.asarray(noise)).items()}
    assert not det["found"].any()


def test_hunt_for_codeword_recovers_timing():
    """LDPC-validated hunt finds the true data start from a wrong nominal
    position (huntForCodeword semantics, ofdm_sync.cpp:469-643)."""
    code = ldpc.get_code(CodeRate.R1_4)
    # Build a v2-looking codeword: set the first two info BYTES to 0x554C.
    from projectultra.protocol import frame_v2 as F
    hdr = F.ControlFrame.make_ack("W1AW", "VE3ABC", 1).serialize()
    from projectultra.utils.bits import bytes_to_bits
    info_bits = np.zeros((1, code.k), np.float32)
    raw = bytes_to_bits(hdr)[:code.k]
    info_bits[0, :len(raw)] = raw
    cw = np.asarray(ldpc_ops.encode(code, jnp.asarray(info_bits)))
    cm = C.carrier_map(CFG)
    ci = channel_interleaver(len(cm.data_idx) * 2, 648)
    inter = cw[:, ci.inv]
    data = np.asarray(M.modulate(CFG, Modulation.QPSK, jnp.asarray(inter)))[0]
    lead = 5000
    sig = np.concatenate([np.zeros(lead, np.float32), data,
                          np.zeros(2000, np.float32)])
    # Correct nominal start: offset 0 wins first in the priority order.
    found, off = SC.hunt_for_codeword(CFG, Modulation.QPSK,
                                      jnp.asarray(sig), lead)
    assert found and off == 0
    # Nominal start 100 samples early (beyond the CP's +-48 tolerance):
    # the hunt recovers an offset that lands within CP of the truth.
    found, off = SC.hunt_for_codeword(CFG, Modulation.QPSK,
                                      jnp.asarray(sig), lead - 100)
    assert found and off in (50, 100)


@pytest.mark.parametrize("T,w", [(1000, 32), (4097, 256), (50, 50)])
def test_window_sum_matches_direct_sliding_sum(T, w):
    """The block-stable sliding sum against a direct numpy sum of every
    window, on a batch of complex rows (the metric's input form)."""
    rng = np.random.default_rng(T)
    x = (rng.standard_normal((3, T)) + 1j * rng.standard_normal((3, T)))
    got = np.asarray(SC._window_sum(jnp.asarray(x.astype(np.complex64)), w))
    want = np.stack([[row[p:p + w].sum() for p in range(T - w + 1)]
                     for row in x])
    assert got.shape == (3, T - w + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.sqrt(w))
