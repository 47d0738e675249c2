"""Long-buffer sliding-energy precision regression tests.

A plain float32 global-cumsum energy window loses ~all mantissa bits past
~50k samples (CLAUDE.md invariant; fixed for Schmidl-Cox via _window_sum).
These tests pin the block-stable behavior for the OTHER two matched-filter
paths: chirp acquisition (sync/chirp.py) and the DPSK Barker timing
refinement (psk/dpsk.py) — each must detect a preamble placed at the END of
a >=500k-sample stream with metrics matching the short-buffer values.
"""

import numpy as np
import jax
import jax.numpy as jnp

from projectultra.psk import dpsk as DP
from projectultra.sync import chirp as CS
from projectultra.sync.schmidl_cox import _window_sum


def test_window_sum_long_buffer_precision():
    """_window_sum stays exact (vs float64) where cumsum differences drift."""
    rng = np.random.default_rng(1)
    T, w = 600_000, 1536
    x = (rng.standard_normal(T).astype(np.float32) + 0.5) ** 2
    exact = np.convolve(x.astype(np.float64), np.ones(w), mode="valid")
    ws = np.asarray(_window_sum(jnp.asarray(x[None, :]), w))[0]
    rel = np.abs(ws - exact) / np.maximum(exact, 1e-9)
    assert rel.max() < 1e-4, f"block-stable window sum drifted: {rel.max()}"
    # The cumsum-difference version, for contrast, is orders worse here.
    c = np.cumsum(np.pad(x, (1, 0)), dtype=np.float32)
    bad = (c[w:] - c[:T - w + 1]).astype(np.float64)
    bad_rel = np.abs(bad - exact) / np.maximum(exact, 1e-9)
    assert bad_rel.max() > rel.max() * 10


def test_chirp_detect_at_end_of_long_stream():
    """Dual-chirp at ~510k samples into a noisy stream: same position/CFO
    tolerances as the short-buffer test (test_chirp_sync.py)."""
    cfg = CS.ChirpConfig()
    c = CS.generate(cfg)
    off = 510_000
    T = off + cfg.total_samples + 10_000
    sig = np.zeros((1, T), np.float32)
    sig[0, off:off + len(c)] = c
    noise = 0.05 * np.random.default_rng(7).standard_normal(T).astype(np.float32)
    r = jax.tree.map(np.asarray,
                     CS.detect_dual_chirp(cfg, jnp.asarray(sig + noise)))
    assert r["success"].all()
    assert abs(int(r["up_chirp_start"][0]) - off) <= 2
    assert abs(float(r["cfo_hz"][0])) < 1.0


def test_dpsk_preamble_at_end_of_long_stream():
    """Barker-13x3 preamble at ~520k samples: find_preamble's matched-filter
    timing refinement must stay sample-accurate (its energy window is where
    the f32 cumsum used to live)."""
    cfg = DP.fast()  # 384 samples/symbol — smallest refine window in presets
    pre = DP.generate_preamble(cfg)
    tr = DP.generate_training(cfg)
    ref = DP.generate_reference(cfg)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (1, 64)).astype(np.float32)
    data = np.asarray(DP.modulate(cfg, jnp.asarray(bits),
                                  initial_symbol_phase=np.pi))
    off = 520_000
    frame = np.concatenate([pre, tr, ref, data[0]])
    T = off + len(frame) + 4 * cfg.samples_per_symbol
    sig = 0.01 * rng.standard_normal(T).astype(np.float32)
    sig[off:off + len(frame)] += frame

    search_syms = (off // cfg.samples_per_symbol) + 8
    found, data_start, cfo, ipo, prev = DP.find_preamble(
        cfg, jnp.asarray(sig[None, :]), max_search_symbols=search_syms)
    assert bool(np.asarray(found)[0])
    assert abs(int(np.asarray(data_start)[0]) - (off + cfg.preamble_samples)) <= 4
    assert abs(float(np.asarray(cfo)[0])) < 1.0
