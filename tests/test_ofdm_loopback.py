"""OFDM TX golden parity + end-to-end loopback tests.

Mirrors tests/test_basic_ofdm.cpp and the test_iwaveform harness semantics
(reference: tools/test_iwaveform.cpp): full encode -> interleave -> modulate
-> channel -> presynced demodulate -> deinterleave -> LDPC decode.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from projectultra.config import ModemConfig, Modulation, CodeRate
from projectultra.fec import ldpc
from projectultra.ofdm import modulator as M
from projectultra.ofdm import pipeline as P
from projectultra.sim import watterson as W
from projectultra.utils.bits import bytes_to_bits

CHIRP_CFG = P.chirp_ofdm_config()


def test_tx_training_and_data_match_reference(golden_dir):
    """Sample-accurate parity with OFDMModulator (float32 FFT tolerance)."""
    payload = bytes.fromhex(
        open(os.path.join(golden_dir, "golden_ofdm_tx_meta.txt")).read().split()[1])
    golden = np.fromfile(os.path.join(golden_dir, "golden_ofdm_tx.f32"),
                         dtype=np.float32)
    gt, gd = golden[:1128], golden[1128:]

    tr = M.generate_training(CHIRP_CFG, 2)
    assert np.abs(tr - gt).max() < 1e-4

    bits = jnp.asarray(bytes_to_bits(payload)[None, :].astype(np.float32))
    dat = np.asarray(M.modulate(CHIRP_CFG, Modulation.DQPSK, bits,
                                t_offset=2 * CHIRP_CFG.symbol_duration))[0]
    assert dat.shape[0] == gd.shape[0]
    assert np.abs(dat - gd).max() < 2e-3 * np.abs(gd).max()


def test_tx_schmidl_cox_preamble_matches_reference(golden_dir):
    cfg = ModemConfig()  # default: 512/30, pilots
    payload = bytes.fromhex(
        open(os.path.join(golden_dir, "golden_ofdm_tx_meta.txt")).read().split()[1])
    gc = np.fromfile(os.path.join(golden_dir, "golden_ofdm_cox_tx.f32"),
                     dtype=np.float32)
    gpre, gdat = gc[:3920], gc[3920:]
    pre = M.generate_preamble(cfg)
    assert np.abs(pre - gpre).max() < 1e-4
    bits = jnp.asarray(bytes_to_bits(payload)[None, :].astype(np.float32))
    dat = np.asarray(M.modulate(cfg, Modulation.QPSK, bits,
                                t_offset=M.preamble_data_t_offset(cfg)))[0]
    assert np.abs(dat - gdat).max() < 2e-3 * np.abs(gdat).max()


def _loopback(channel_fn, cfo_for_rx=0.0, B=4, seed=0):
    """TX -> channel_fn -> RX for B random frames; returns (ok, bit_match)."""
    code = ldpc.get_code(CodeRate.R1_2)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    tx = P.tx_frame(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2, jnp.asarray(info))
    rx_in = channel_fn(tx)
    out, ok, _ = P.rx_frame(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2,
                            rx_in, cfo_hz=cfo_for_rx)
    match = (np.asarray(out) == info.astype(np.uint8)).all(axis=-1)
    return np.asarray(ok), match


def test_loopback_clean():
    ok, match = _loopback(lambda tx: tx)
    assert ok.all() and match.all()


def test_loopback_awgn_17db():
    """OFDM_CHIRP AWGN SNR=17 -> 100% decode (regression_matrix.sh:169-180)."""
    key = jax.random.PRNGKey(1)
    ok, match = _loopback(lambda tx: W.add_noise_active(key, tx, 17.0), B=8)
    assert ok.all() and match.all()


def test_loopback_awgn_with_cfo():
    """CFO=30 Hz applied via Hilbert SSB shift (INV-CFO-003), known to RX."""
    key = jax.random.PRNGKey(2)
    cfo = 30.0

    def chan(tx):
        shifted = W.apply_cfo_hilbert(tx, jnp.full((tx.shape[0],), cfo))
        return W.add_noise_active(key, shifted, 17.0)

    ok, match = _loopback(chan, cfo_for_rx=cfo, B=8)
    assert ok.all() and match.all()


def test_loopback_multi_codeword():
    """3 codewords in one frame (multi-CW frames, PROTOCOL_V2.md:404-470)."""
    code = ldpc.get_code(CodeRate.R1_2)
    rng = np.random.default_rng(3)
    B, ncw = 2, 3
    info = rng.integers(0, 2, size=(B, ncw, code.k)).astype(np.float32)
    from projectultra.ops import ldpc as ldpc_ops
    from projectultra.fec.interleave import channel_interleaver
    from projectultra.ofdm import carriers as C

    cw = np.asarray(ldpc_ops.encode(code, jnp.asarray(info.reshape(B * ncw, -1))))
    cm = C.carrier_map(CHIRP_CFG)
    bps = len(cm.data_idx) * 2
    ci = channel_interleaver(bps, 648)
    inter = cw[:, ci.inv].reshape(B, ncw * 648)

    data = M.modulate(CHIRP_CFG, Modulation.DQPSK, jnp.asarray(inter),
                      t_offset=2 * CHIRP_CFG.symbol_duration)
    tr = jnp.broadcast_to(jnp.asarray(M.generate_training(CHIRP_CFG, 2)), (B, 1128))
    tx = jnp.concatenate([tr, data], axis=-1)

    out, ok, _ = P.rx_frame(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2, tx,
                            n_codewords=ncw)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out).reshape(B, ncw, -1),
                                  info.astype(np.uint8))


def test_loopback_coherent_qam16_pilots():
    """Coherent 16QAM with pilot tracking over a clean channel
    (NVIS-style path, channel_equalizer.cpp pilot loop)."""
    cfg = ModemConfig()  # pilots, spacing 2 -> 15 data carriers
    code = ldpc.get_code(CodeRate.R2_3)
    rng = np.random.default_rng(5)
    B = 2
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    tx = P.tx_frame(cfg, Modulation.QAM16, CodeRate.R2_3, jnp.asarray(info))
    key = jax.random.PRNGKey(7)
    rx_in = W.add_noise_active(key, tx, 25.0)
    out, ok, _ = P.rx_frame(cfg, Modulation.QAM16, CodeRate.R2_3, rx_in)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), info.astype(np.uint8))


def test_fast_path_matches_scan_path():
    """The parallel no-pilot differential demod must match the scan path
    bit-for-bit (same LLRs)."""
    from projectultra.ofdm import demodulator as D

    code = ldpc.get_code(CodeRate.R1_2)
    rng = np.random.default_rng(17)
    info = rng.integers(0, 2, size=(2, code.k)).astype(np.float32)
    tx = P.tx_frame(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2, jnp.asarray(info))
    rx = W.add_noise_active(jax.random.PRNGKey(3), tx, 12.0)
    rx = W.apply_cfo_hilbert(rx, jnp.asarray([15.0, -20.0]))
    cfo = jnp.asarray([15.0, -20.0])
    S = P.num_data_symbols(CHIRP_CFG, Modulation.DQPSK, 1)

    fast, _ = D.demodulate_presynced(CHIRP_CFG, Modulation.DQPSK, rx, cfo, 0.0,
                                     training_symbols=2, num_data_symbols=S)

    # Scan path, driven directly (same maybe_analytic input the presynced
    # entry point uses — a no-op for differential DQPSK).
    B, L = 2, CHIRP_CFG.symbol_duration
    rxa = D.maybe_analytic(Modulation.DQPSK, rx)
    st = D.init_state(CHIRP_CFG, B, cfo, 0.0)
    st = D.estimate_channel_from_lts(
        CHIRP_CFG, st, rxa[:, :2 * L].reshape(B, 2, L))
    data = rxa[:, 2 * L:(2 + S) * L].reshape(B, S, L)
    _, scan = D._scan_data_symbols(CHIRP_CFG, Modulation.DQPSK, st, data,
                                   t0_base=2 * L)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(scan),
                               rtol=0, atol=2e-4)


def test_equalized_presynced_demaps_to_presynced_llrs():
    """The equalized symbols the backend comparison reads are exactly what
    the presynced demod demaps: demapping them gives its LLRs (to f32
    rounding: the two programs fuse the arithmetic differently)."""
    from projectultra.ofdm import demodulator as D
    from projectultra.ops import demap

    code = ldpc.get_code(CodeRate.R1_2)
    info = np.random.default_rng(19).integers(0, 2, (2, code.k))
    tx = P.tx_frame(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2,
                    jnp.asarray(info, jnp.float32))
    rx = W.add_noise_active(jax.random.PRNGKey(4), tx, 0.0)
    cfo = jnp.asarray([10.0, -5.0])
    S = P.num_data_symbols(CHIRP_CFG, Modulation.DQPSK, 1)

    llrs, _ = D.demodulate_presynced(CHIRP_CFG, Modulation.DQPSK, rx, cfo,
                                     0.0, training_symbols=2,
                                     num_data_symbols=S)
    eq, prev, cnv = D.equalized_presynced(CHIRP_CFG, Modulation.DQPSK, rx,
                                          training_symbols=2,
                                          num_data_symbols=S, cfo_hz=cfo)
    assert eq.shape == prev.shape == (2, S, eq.shape[-1])
    assert cnv.shape == (2, 1, eq.shape[-1])
    again = demap.demap(Modulation.DQPSK, eq, cnv, prev=prev).reshape(2, -1)
    np.testing.assert_allclose(np.asarray(again), np.asarray(llrs),
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="no-pilot differential"):
        D.equalized_presynced(ModemConfig(), Modulation.DQPSK, rx,
                              training_symbols=2, num_data_symbols=S)
