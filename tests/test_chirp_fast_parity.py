"""Decimated-search chirp detector vs an exact full-rate matched filter.

The round-3 detect_dual_chirp searches on an fs/8 complex-baseband grid and
refines candidates at full rate (sync/chirp.py module docstring).  These
tests pin the contract that refinement restores round-2 exactness: detected
positions match an exact full-rate matched filter to within +-2 samples and
reported correlations to a few percent, across SNR/CFO/offset scenarios.
"""

import numpy as np
import jax
import jax.numpy as jnp

from projectultra.sync import chirp as CS
from projectultra.sim import watterson as W

CFG = CS.ChirpConfig()


def _exact_up_corr(sig: np.ndarray, off_lo: int, off_hi: int):
    """Full-rate normalized up-chirp correlation over [off_lo, off_hi):
    the round-2 definition, computed directly."""
    up, _, e_up, _ = CS._templates(CFG)
    L = CFG.chirp_samples
    out = np.zeros(off_hi - off_lo)
    for i, p in enumerate(range(off_lo, off_hi)):
        seg = sig[p:p + L].astype(np.float64)
        num = np.abs((seg * np.conj(up)).sum())
        den = np.sqrt((seg ** 2).sum() * e_up)
        out[i] = num / den if den > 1e-10 else 0.0
    return out


def test_positions_and_corr_match_exact():
    rng = np.random.default_rng(42)
    offs = [3000, 11111, 30005]
    cfos = [0.0, 17.0, -40.0]
    c = CS.generate(CFG)
    T = CFG.total_samples + 40000
    for off, cfo in zip(offs, cfos):
        cfg_tx = CS.ChirpConfig(tx_cfo_hz=cfo)
        sig = np.zeros(T, np.float32)
        sig[off:off + len(c)] = CS.generate(cfg_tx)
        noisy = sig + rng.normal(0, 0.05, T).astype(np.float32)
        det = {k: np.asarray(v)[0] for k, v in
               CS.detect_dual_chirp(CFG, jnp.asarray(noisy[None, :])).items()}
        assert det["success"]
        assert abs(float(det["cfo_hz"]) - cfo) < 1.5
        assert abs(int(det["up_chirp_start"]) - off) <= 3
        # Reported correlation equals the exact full-rate peak (within the
        # integer-grid neighborhood the parabolic refine rounds over).
        shift = int(round(-cfo * CFG.cfo_to_samples))
        peak_region = _exact_up_corr(noisy, off + shift - 3, off + shift + 4)
        assert abs(det["up_correlation"] - peak_region.max()) < 0.02


def test_noise_only_rejected():
    rng = np.random.default_rng(1)
    noise = rng.normal(0, 0.3, (4, CFG.total_samples + 30000)).astype(np.float32)
    det = CS.detect_dual_chirp(CFG, jnp.asarray(noise))
    assert not bool(np.asarray(det["success"]).any())


def test_weak_threshold_minus20db():
    """The engine's weak second pass (threshold 0.08) must still detect at
    -20 dB wideband SNR (modem_rx.cpp:74 'works down to -20 dB')."""
    c = CS.generate(CFG)
    T = CFG.total_samples + 30000
    sig = np.zeros((8, T), np.float32)
    sig[:, 5000:5000 + len(c)] = c
    noisy = np.asarray(W.add_noise_active(
        jax.random.PRNGKey(3), jnp.asarray(sig), -20.0))
    det = CS.detect_dual_chirp(CFG, jnp.asarray(noisy), threshold=0.08)
    ok = np.asarray(det["success"])
    err = np.abs(np.asarray(det["up_chirp_start"]) - 5000)
    assert ok.all()
    assert (err[ok] <= 24).all()
