"""MC-DPSK golden parity + loopback tests.

Reference: src/psk/multi_carrier_dpsk.hpp; golden vectors dumped from the
unmodified reference (tests/data/golden/golden_mcdpsk_*).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

from projectultra.config import CodeRate
from projectultra.fec import ldpc
from projectultra.ops import ldpc as ldpc_ops
from projectultra.psk import mc_dpsk as MC
from projectultra.sim import watterson as W
from projectultra.utils.bits import bytes_to_bits

CFG = MC.MCDPSKConfig()


def _meta(golden_dir):
    lines = open(os.path.join(golden_dir, "golden_mcdpsk_meta.txt")).read().split("\n")
    payload = bytes.fromhex(lines[0].split()[1])
    hdr = lines[1].split()
    sizes = dict(zip(hdr[::2], hdr[1::2]))
    soft = np.array([float(x) for x in lines[2].split()[1:]], np.float32)
    return payload, sizes, soft


def test_tx_matches_reference(golden_dir):
    payload, sizes, _ = _meta(golden_dir)
    golden = np.fromfile(os.path.join(golden_dir, "golden_mcdpsk_tx.f32"),
                         dtype=np.float32)
    tr_n, ref_n = int(sizes["training"]), int(sizes["ref"])
    gt, gr, gd = golden[:tr_n], golden[tr_n:tr_n + ref_n], golden[tr_n + ref_n:]

    tr = MC.generate_training(CFG)
    ref = MC.generate_reference(CFG)
    assert np.abs(tr - gt).max() < 2e-4
    assert np.abs(ref - gr).max() < 2e-4

    bits = jnp.asarray(bytes_to_bits(payload)[None, :].astype(np.float32))
    dat = np.asarray(MC.modulate(CFG, bits))[0]
    assert dat.shape[0] == gd.shape[0]
    assert np.abs(dat - gd).max() < 2e-3


def test_soft_bits_match_reference(golden_dir):
    """Clean-channel demod LLRs match the C++ demodulator."""
    payload, sizes, gsoft = _meta(golden_dir)
    golden = np.fromfile(os.path.join(golden_dir, "golden_mcdpsk_tx.f32"),
                         dtype=np.float32)
    samples = jnp.asarray(golden[None, :])
    n_sym = MC.num_symbols_for_bits(CFG, len(payload) * 8)
    llrs = np.asarray(MC.demodulate_presynced(
        CFG, samples, jnp.zeros(1), jnp.zeros(1), n_sym))[0]
    assert llrs.shape[0] == len(gsoft)
    assert np.abs(llrs - gsoft).max() < 0.05


def _mc_loopback(channel_fn, cfo_for_rx=0.0, train_abs=0.0, B=4, seed=0,
                 snr_check=True):
    code = ldpc.get_code(CodeRate.R1_4)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    cw = ldpc_ops.encode(code, jnp.asarray(info))        # [B, 648]
    data = MC.modulate(CFG, cw)
    pre = np.concatenate([MC.generate_training(CFG), MC.generate_reference(CFG)])
    tx = jnp.concatenate(
        [jnp.broadcast_to(jnp.asarray(pre), (B, len(pre))), data], axis=-1)
    rx_in = channel_fn(tx)
    n_sym = MC.num_symbols_for_bits(CFG, 648)
    llrs = MC.demodulate_presynced(
        CFG, rx_in, jnp.full((B,), cfo_for_rx), jnp.full((B,), train_abs), n_sym)
    out, ok, _ = ldpc_ops.decode(code, llrs[:, :648])
    match = (np.asarray(out) == info.astype(np.uint8)).all(-1)
    return np.asarray(ok), match


def test_loopback_clean():
    ok, match = _mc_loopback(lambda tx: tx)
    assert ok.all() and match.all()


def test_loopback_awgn_snr5():
    """MC-DPSK AWGN SNR=5 -> 100% decode (regression_matrix.sh:137-146)."""
    key = jax.random.PRNGKey(3)
    ok, match = _mc_loopback(lambda tx: W.add_noise_active(key, tx, 5.0), B=8)
    assert ok.all() and match.all()


def test_estimate_snr_db_tracks_true_snr():
    """SNR estimator tracks the per-carrier post-correlation SNR — the
    reference's getEstimatedSNR semantics (channel_equalizer.cpp:221:
    |H|^2 / per-carrier noise variance), which exceeds the wideband audio
    SNR by the correlation processing gain 10*log10(N / (2*C))."""
    gain_db = 10.0 * np.log10(CFG.samples_per_symbol / (2.0 * CFG.num_carriers))
    tr = jnp.broadcast_to(jnp.asarray(MC.generate_training(CFG)),
                          (3, CFG.training_samples))
    key = jnp.asarray(jax.random.PRNGKey(7))
    ests = []
    for true_snr in (-5.0, 0.0, 10.0, 20.0, 30.0):
        noisy = W.add_noise_active(key, tr, true_snr)
        est = np.asarray(MC.estimate_snr_db(CFG, noisy))
        ests.append(est.mean())
        # Tracks truth + processing gain across the whole range (the LS fit
        # against the leakage-inclusive clean correlations removes the
        # inter-carrier-leakage saturation floor).
        assert np.all(np.abs(est - (true_snr + gain_db)) < 3.0), (true_snr, est)
    assert ests == sorted(ests)  # monotone in true SNR
    clean = np.asarray(MC.estimate_snr_db(CFG, tr))
    assert np.all(clean > 45.0), clean


def test_loopback_awgn_snr5_cfo30():
    """PRESYNCED kernel check at the matrix row's operating point (AWGN
    SNR=5, CFO=30): oracle position + true CFO isolate the demod/LDPC
    chain.  The actual regression row (real chirp detection, estimated
    CFO, no oracle) runs in parallel/sweep + tools/regression_matrix.py.
    The CFO ramp starts at the training start (train_abs=0)."""
    key = jax.random.PRNGKey(4)
    cfo = 30.0

    def chan(tx):
        shifted = W.apply_cfo_hilbert(tx, jnp.full((tx.shape[0],), cfo))
        return W.add_noise_active(key, shifted, 5.0)

    ok, match = _mc_loopback(chan, cfo_for_rx=cfo, B=8)
    assert ok.all() and match.all()


def test_presynced_intra_offset_matches_sliced_path():
    """The block-aligned over-slice + intra_offset FFT-ramp path (the
    bench's acquisition gather, docs/PERF.md round 4) must match the
    exact-slice golden path: same hard decisions, near-identical LLRs."""
    mc = MC.level10()
    code = ldpc.get_code(CodeRate.R1_4)
    rng = np.random.default_rng(11)
    B = 4
    info = jnp.asarray(rng.integers(0, 2, (B, code.k)).astype(np.float32))
    cw = ldpc_ops.encode(code, info)
    n_sym = MC.num_symbols_for_bits(mc, code.n)
    data = MC.modulate(mc, cw)
    lead = 777  # deliberately NOT block-aligned
    tx = jnp.concatenate([
        jnp.zeros((B, lead)),
        jnp.broadcast_to(jnp.asarray(np.concatenate(
            [MC.generate_training(mc), MC.generate_reference(mc)])),
            (B, mc.training_samples + mc.ref_samples)),
        data, jnp.zeros((B, 900))], axis=-1).astype(jnp.float32)
    rx = W.add_noise_active(jax.random.PRNGKey(5), tx, 8.0)
    span_len = (mc.training_samples + mc.ref_samples
                + n_sym * mc.samples_per_symbol)
    T = rx.shape[-1]

    for cfo_true in (0.0, 2.5):  # exercise both CFO-active branches
        cfo = jnp.full((B,), cfo_true, jnp.float32)
        tr = jnp.full((B,), lead, jnp.int32)
        exact = jax.vmap(lambda b, s: jax.lax.dynamic_slice(
            b, (s,), (span_len,)))(rx, tr)
        llr_ref = MC.demodulate_presynced(mc, exact, cfo,
                                          tr.astype(jnp.float32), n_sym)

        ALIGN = 128
        span_pad = -(-(span_len + 2 * ALIGN) // ALIGN) * ALIGN
        s0 = jnp.clip((tr // ALIGN) * ALIGN, 0, T - span_pad)
        r = tr - s0
        span = jax.vmap(lambda b, s: jax.lax.dynamic_slice(
            b, (s,), (span_pad,)))(rx, s0)
        llr_fast = MC.demodulate_presynced(mc, span, cfo,
                                           tr.astype(jnp.float32), n_sym,
                                           intra_offset=r)

        a, b = np.asarray(llr_ref), np.asarray(llr_fast)
        # identical hard decisions; LLR deviation limited to FFT-window
        # edge effects (the over-slice sees a longer Hilbert window)
        assert (np.sign(a) == np.sign(b)).mean() > 0.999
        assert np.abs(a - b).mean() < 0.05

        out, ok, _ = ldpc_ops.decode(code, jnp.asarray(b)[:, :code.n])
        assert bool(ok.all())
        assert (np.asarray(out) == np.asarray(info, np.uint8)).all()
