"""OTFS mod/demod tests: transform roundtrips, loopback, channel behavior.

Reference: src/otfs/otfs.cpp, tests via tools/test_otfs_vs_ofdm.cpp semantics.
"""

import numpy as np
import jax
import jax.numpy as jnp

from projectultra.config import Modulation, CodeRate
from projectultra.fec import ldpc
from projectultra.ops import ldpc as ldpc_ops
from projectultra.otfs import otfs as O
from projectultra.sim import watterson as W
from projectultra.utils.bits import bytes_to_bits

CFG = O.OTFSConfig()


def test_tx_matches_reference(golden_dir):
    """Preamble + one QPSK frame sample-for-sample vs the C++ OTFSModulator
    (golden dumped from the unmodified reference build)."""
    import os
    lines = open(os.path.join(golden_dir, "golden_otfs_meta.txt")).read().split("\n")
    payload = bytes.fromhex(lines[0].split()[1])
    sizes = dict(zip(lines[1].split()[::2], lines[1].split()[1::2]))
    golden = np.fromfile(os.path.join(golden_dir, "golden_otfs_tx.f32"),
                         dtype=np.float32)
    pre_n = int(sizes["preamble"])
    assert pre_n == CFG.preamble_len
    assert len(golden) - pre_n == CFG.N * CFG.sym_len

    bits = jnp.asarray(bytes_to_bits(payload)[None, :].astype(np.float32))
    tx = np.asarray(O.frame_tx(CFG, Modulation.QPSK, bits))[0]
    assert tx.shape[0] == golden.shape[0]
    assert np.abs(tx - golden).max() < 2e-3

    # RX interop: our demodulator recovers the payload from the C++ audio.
    llrs = np.asarray(O.demodulate_frame(CFG, Modulation.QPSK,
                                         jnp.asarray(golden[None, :])))[0]
    hard = (llrs < 0).astype(np.float32)[:bits.shape[-1]]
    assert (hard == np.asarray(bits)[0]).all()


def test_isfft_sfft_roundtrip():
    rng = np.random.default_rng(0)
    dd = (rng.standard_normal((2, 32, 16)) + 1j * rng.standard_normal((2, 32, 16))
          ).astype(np.complex64)
    tf = O.isfft(jnp.asarray(dd))
    back = np.asarray(O.sfft(tf))
    np.testing.assert_allclose(back, dd, atol=1e-4)


def test_grid_fill_order_matches_reference():
    """First QPSK symbol lands at dd[0,0], second at dd[0,1] (k-major fill,
    otfs.cpp:318-338)."""
    bits = jnp.asarray(np.array([[0, 0, 1, 1]], np.float32))  # 00 then 11
    dd = np.asarray(O.map_bits_to_dd(CFG, Modulation.QPSK, bits))[0]
    s = 0.7071067811865476
    np.testing.assert_allclose(dd[0, 0], complex(-s, -s), atol=1e-6)
    np.testing.assert_allclose(dd[0, 1], complex(s, s), atol=1e-6)
    assert dd[0, 2] == 0  # unfilled cells stay empty


def _otfs_loopback(channel_fn=None, tf_eq=True, B=4, seed=0,
                   rate=CodeRate.R1_4):
    cfg = O.OTFSConfig(tf_equalization=tf_eq)
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(seed)
    # One LDPC codeword (648 bits) per OTFS frame (modem_engine.cpp:421-455).
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    cw = ldpc_ops.encode(code, jnp.asarray(info))          # [B, 648]
    tx = O.frame_tx(cfg, Modulation.QPSK, cw)
    rx_in = channel_fn(tx) if channel_fn else tx
    llrs = O.demodulate_frame(cfg, Modulation.QPSK, rx_in)
    out, ok, _ = ldpc_ops.decode(code, llrs[:, :648])
    match = (np.asarray(out) == info.astype(np.uint8)).all(-1)
    return np.asarray(ok), match


def test_loopback_clean():
    ok, match = _otfs_loopback()
    assert ok.all() and match.all()


def test_loopback_awgn():
    key = jax.random.PRNGKey(1)
    ok, match = _otfs_loopback(lambda tx: W.add_noise_active(key, tx, 20.0))
    assert ok.all() and match.all()


def test_loopback_fading():
    """Good-channel fading: OTFS_EQ decodes 100% (the reference's adaptive
    modem picks OTFS_EQ for Good channels); RAW still gets most frames."""
    key = jax.random.PRNGKey(2)

    def chan(tx):
        return W.watterson(key, tx, W.good(25.0))

    ok_eq, match_eq = _otfs_loopback(chan, tf_eq=True, B=8)
    assert ok_eq.all() and match_eq.all()
    ok_raw, match_raw = _otfs_loopback(chan, tf_eq=False, B=8)
    # Note: min-sum can converge to a wrong codeword under deep fades
    # (parity-valid false positive); the frame CRC catches those at the
    # protocol layer, so only count frames that decoded AND match.
    assert (ok_raw & match_raw).mean() >= 0.5


def test_detect_frame():
    cfg = CFG
    code = ldpc.get_code(CodeRate.R1_4)
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, size=(1, code.k)).astype(np.float32)
    cw = ldpc_ops.encode(code, jnp.asarray(info))
    tx = np.asarray(O.frame_tx(cfg, Modulation.QPSK, cw))
    sig = np.concatenate([np.zeros((1, 4000), np.float32), tx,
                          np.zeros((1, 2000), np.float32)], axis=-1)
    found, start = O.detect_frame(cfg, jnp.asarray(sig))
    assert bool(np.asarray(found)[0])
    # The 0.98-threshold fine-sync rule lands within ~half a CP of the true
    # start (the reference's rule has the same bias, otfs.cpp:478-500);
    # CP=64 absorbs it.
    assert abs(int(np.asarray(start)[0]) - 4000) <= 32


def test_detect_frame_at_operating_snr():
    """Detection must gate on the 0.7 coarse threshold, not the 0.98
    fine-timing rule: at 12 dB (above the waveform's 10 dB floor) the
    repeated-symbol metric tops out near SNR/(1+SNR) ~ 0.94, which the old
    fine-only gate rejected (review finding).  End-to-end: detect on the
    noisy stream, then decode through the engine-style refined start."""
    from projectultra.sim import watterson as W
    cfg = CFG
    code = ldpc.get_code(CodeRate.R1_4)
    rng = np.random.default_rng(5)
    info = rng.integers(0, 2, size=(2, code.k)).astype(np.float32)
    cw = ldpc_ops.encode(code, jnp.asarray(info))
    tx = np.asarray(O.frame_tx(cfg, Modulation.QPSK, cw))
    sig = np.concatenate([np.zeros((2, 4000), np.float32), tx,
                          np.zeros((2, 2000), np.float32)], axis=-1)
    noisy = W.add_noise_active(jax.random.PRNGKey(2), jnp.asarray(sig), 12.0)
    found, start = O.detect_frame(cfg, noisy)
    assert np.asarray(found).all()
    # Coarse-fallback timing lands within a couple of symbols; the engine
    # refines with a preamble matched filter before decoding.
    assert (np.abs(np.asarray(start) - 4000) < 2 * cfg.sym_len).all()
