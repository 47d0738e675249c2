"""Single-carrier DPSK golden parity + loopback (config #1: 125 baud DQPSK).

Reference: src/psk/dpsk.hpp; golden vectors from the unmodified reference.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

from projectultra.config import CodeRate
from projectultra.fec import ldpc
from projectultra.ops import ldpc as ldpc_ops
from projectultra.psk import dpsk as D
from projectultra.sim import watterson as W
from projectultra.utils.bits import bytes_to_bits

CFG = D.fast()  # DQPSK @125 baud


def _meta(golden_dir):
    lines = open(os.path.join(golden_dir, "golden_dpsk_meta.txt")).read().split("\n")
    payload = bytes.fromhex(lines[0].split()[1])
    hdr = lines[1].split()
    meta = dict(zip(hdr[::2], hdr[1::2]))
    soft = np.array([float(x) for x in lines[2].split()[1:]], np.float32)
    return payload, meta, soft


def test_tx_matches_reference(golden_dir):
    payload, meta, _ = _meta(golden_dir)
    golden = np.fromfile(os.path.join(golden_dir, "golden_dpsk_tx.f32"),
                         dtype=np.float32)
    pre_n = int(meta["pre"])
    gpre, gdat = golden[:pre_n], golden[pre_n:]

    pre = D.generate_preamble(CFG)
    assert len(pre) == pre_n
    # The C++ NCO accumulates float32 phase over ~15k samples; our phase is
    # exact, so the difference is the reference's drift (<1e-3 amplitude).
    assert np.abs(pre - gpre).max() < 1.5e-3

    bits = jnp.asarray(bytes_to_bits(payload)[None, :].astype(np.float32))
    # After Barker x3 the accumulated DBPSK phase is 6*pi == 0.
    dat = np.asarray(D.modulate(CFG, bits, initial_symbol_phase=0.0))[0]
    assert dat.shape[0] == gdat.shape[0]
    # Reference carrier phase drift grows to ~0.013 rad by the end of the
    # frame (float32 accumulator over 47k samples); per-symbol correlation
    # against the golden data is still 1.0000.
    assert np.abs(dat - gdat).max() < 2e-2
    for s in range(0, 10):
        a = dat[s * 384:(s + 1) * 384]
        b = gdat[s * 384:(s + 1) * 384]
        c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
        assert c > 0.99999


def test_find_preamble_and_soft_match_reference(golden_dir):
    payload, meta, gsoft = _meta(golden_dir)
    golden = np.fromfile(os.path.join(golden_dir, "golden_dpsk_tx.f32"),
                         dtype=np.float32)
    full = np.concatenate([np.zeros(2000, np.float32), golden,
                           np.zeros(8000, np.float32)])
    found, ds, cfo, ipo, prev = jax.tree.map(
        np.asarray, D.find_preamble(CFG, jnp.asarray(full[None, :])))
    assert found[0]
    assert abs(int(ds[0]) - int(meta["data_start"])) <= 4
    assert abs(float(cfo[0]) - float(meta["cfo"])) < 1.0

    dat_n = int(meta["dat"])
    data = jnp.asarray(full[None, int(ds[0]):int(ds[0]) + dat_n])
    llrs = np.asarray(D.demodulate_soft(CFG, data, jnp.asarray(prev),
                                        jnp.asarray(cfo), jnp.asarray(ipo)))[0]
    assert llrs.shape[0] == len(gsoft)
    assert np.abs(llrs - gsoft).max() < 0.05


def test_loopback_low_snr():
    """DPSK R1/4 at low SNR: the -11 dB floor claim is for 31.25-baud DBPSK;
    here we verify the 125-baud DQPSK path decodes at 5 dB AWGN."""
    code = ldpc.get_code(CodeRate.R1_4)
    rng = np.random.default_rng(11)
    B = 4
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    cw = ldpc_ops.encode(code, jnp.asarray(info))
    pre = D.generate_preamble(CFG)
    data = D.modulate(CFG, cw)
    tx = jnp.concatenate(
        [jnp.broadcast_to(jnp.asarray(pre), (B, len(pre))), data], axis=-1)
    tx = jnp.concatenate([tx, jnp.zeros((B, 4000))], axis=-1)
    key = jax.random.PRNGKey(5)
    noisy = W.add_noise_active(key, tx, 5.0)

    found, ds, cfo, ipo, prev = D.find_preamble(CFG, noisy)
    assert np.asarray(found).all()
    # All frames share the same aligned start; use static slicing.
    start = int(np.asarray(ds)[0])
    n_dat = data.shape[-1]
    llrs = D.demodulate_soft(CFG, noisy[:, start:start + n_dat], prev, cfo, ipo)
    out, ok, _ = ldpc_ops.decode(code, llrs[:, :648])
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), info.astype(np.uint8))


def test_loopback_dbpsk_robust_neg_snr():
    """31.25-baud DBPSK at -8 dB AWGN (low-SNR floor regime, README.md:38)."""
    cfg = D.robust()
    code = ldpc.get_code(CodeRate.R1_4)
    rng = np.random.default_rng(12)
    B = 2
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    cw = ldpc_ops.encode(code, jnp.asarray(info))
    pre = D.generate_preamble(cfg)
    data = D.modulate(cfg, cw)
    tx = jnp.concatenate(
        [jnp.broadcast_to(jnp.asarray(pre), (B, len(pre))), data], axis=-1)
    key = jax.random.PRNGKey(6)
    noisy = W.add_noise_active(key, tx, -8.0)
    prev = D.correlate_symbols(cfg, jnp.asarray(pre[None, -cfg.samples_per_symbol:]))[:, 0]
    prev = jnp.broadcast_to(prev, (B,))
    llrs = D.demodulate_soft(cfg, noisy[:, len(pre):], prev)
    out, ok, _ = ldpc_ops.decode(code, llrs[:, :648])
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), info.astype(np.uint8))
