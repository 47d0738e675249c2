"""Dual-chirp generation + detection tests.

Reference behavior: src/sync/chirp_sync.hpp (generate :59-105, detectDualChirp
:349-505).  Detection must find the chirp position to within a few samples and
estimate CFO to ~1-2 Hz under AWGN.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from projectultra.sync import chirp as CS
from projectultra.sim import watterson as W

CFG = CS.ChirpConfig()


def test_generate_layout():
    s = CS.generate(CFG)
    L, G = CFG.chirp_samples, CFG.gap_samples
    assert len(s) == 2 * L + 2 * G == CFG.total_samples
    assert np.abs(s[:L]).max() > 0.4
    assert np.all(s[L:L + G] == 0)
    assert np.abs(s[L + G:2 * L + G]).max() > 0.4
    assert np.all(s[2 * L + G:] == 0)


def test_detect_clean():
    offsets = [3000, 12345]
    B = len(offsets)
    T = CFG.total_samples + 20000
    sig = np.zeros((B, T), np.float32)
    c = CS.generate(CFG)
    for b, off in enumerate(offsets):
        sig[b, off:off + len(c)] = c
    r = jax.tree.map(np.asarray, CS.detect_dual_chirp(CFG, jnp.asarray(sig)))
    assert r["success"].all()
    for b, off in enumerate(offsets):
        assert abs(int(r["up_chirp_start"][b]) - off) <= 2
        assert abs(float(r["cfo_hz"][b])) < 1.0


def test_detect_with_cfo_and_noise():
    """CFO=30 Hz, SNR=5 dB AWGN: CFO estimate within ~2 Hz, position within
    ~24 samples (regression_matrix MC-DPSK rows rely on this accuracy)."""
    cfo_true = 30.0
    off = 9000
    T = CFG.total_samples + 30000
    c = CS.generate(CFG)
    sig = np.zeros((2, T), np.float32)
    sig[:, off:off + len(c)] = c
    shifted = W.apply_cfo_hilbert(jnp.asarray(sig), jnp.full((2,), cfo_true))
    key = jax.random.PRNGKey(0)
    noisy = W.add_noise_active(key, shifted, 5.0)
    r = jax.tree.map(np.asarray, CS.detect_dual_chirp(CFG, noisy))
    assert r["success"].all()
    assert np.abs(r["cfo_hz"] - cfo_true).max() < 2.5
    assert np.abs(r["up_chirp_start"] - off).max() <= 24


def test_training_start_and_phase():
    ds = jnp.asarray([1000], jnp.int32)
    ts = CS.training_start(CFG, ds)
    assert int(ts[0]) == 1000 + CFG.chirp_samples + CFG.gap_samples
    ph = CS.initial_cfo_phase(CFG, jnp.asarray([30.0]), ts)
    assert -np.pi <= float(ph[0]) <= np.pi


def test_earliest_weak_chirp_wins_over_later_strong():
    """Earliest-chirp-wins must hold even when the early frame is FADED:
    a 0.2x-amplitude chirp ahead of a full-strength one must be the
    detection result (review finding: the 0.7*gmax floor used to skip it,
    silently dropping the early frame).  The strong chirp is reported as
    next_up_start so consumers cap consumption before it."""
    from projectultra.psk import mc_dpsk as MC
    from projectultra.sim import watterson as W
    mc = MC.level10()
    cc = mc.chirp_config()
    ch = CS.generate(cc)
    buf = np.zeros(200000, np.float32)
    buf[5000:5000 + len(ch)] = 0.2 * ch
    buf[120000:120000 + len(ch)] = ch
    noisy = np.asarray(W.add_noise_active(
        jax.random.PRNGKey(0), jnp.asarray(buf[None, :]), 10.0))[0]
    det = {k: np.asarray(v)[0] for k, v in
           CS.detect_dual_chirp(cc, jnp.asarray(noisy[None, :])).items()}
    assert bool(det["success"])
    assert abs(int(det["up_chirp_start"]) - 5000) < 100
    assert abs(int(det["next_up_start"]) - 120000) < 200


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_bf16_switch_refused_on_gpu(monkeypatch, backend):
    """ULTRA_CHIRP_BF16=1 is allowed on the CPU and refused, with an error
    rather than a hang, on the GPU."""
    monkeypatch.setattr(CS, "_BF16", True)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if backend == "gpu":
        with pytest.raises(RuntimeError, match="refused on the GPU"):
            CS._refuse_bf16_on_gpu()
    else:
        CS._refuse_bf16_on_gpu()
