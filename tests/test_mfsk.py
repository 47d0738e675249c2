"""Adaptive MFSK (2-32 tones) loopback at the documented operating points.

Reference: src/fsk/mfsk.hpp presets (mfsk_presets:545-582 — robust -12 dB /
low_snr -8 / medium -4 / fast 0 / turbo +3 "reported" SNR).  Each test runs
the full chain with the tone-sweep preamble search in the loop (no oracle
positions): modulate -> AWGN -> find_preamble -> dynamic-slice ->
repetition-combined soft demod -> LDPC R1/4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from projectultra.config import CodeRate
from projectultra.fec import ldpc
from projectultra.ops import ldpc as ldpc_ops
from projectultra.psk import fsk
from projectultra.sim import watterson as W

CODE = ldpc.get_code(CodeRate.R1_4)


def _loopback(cfg: fsk.MFSKConfig, snr_db: float, B: int = 4,
              seed: int = 1, cfo_hz: float = 0.0) -> float:
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, CODE.k)).astype(np.float32)
    cw = np.asarray(ldpc_ops.encode(CODE, jnp.asarray(info)))
    pre = fsk.mfsk_generate_preamble(cfg)
    data = np.asarray(fsk.mfsk_modulate(cfg, cw))
    sig = np.concatenate([np.zeros((B, 5000), np.float32),
                          np.tile(pre, (B, 1)), data,
                          np.zeros((B, 4000), np.float32)], axis=-1)
    x = jnp.asarray(sig)
    if cfo_hz:
        x = W.apply_cfo_hilbert(x, jnp.full((B,), cfo_hz))
    x = W.add_noise_active(jax.random.PRNGKey(seed), x, snr_db)

    found, ds = fsk.mfsk_find_preamble(cfg, x)
    L = cfg.samples_per_symbol
    n_sym = -(-CODE.n // cfg.bits_per_symbol) * cfg.repetition
    span = jax.vmap(
        lambda b, s: jax.lax.dynamic_slice(b, (s,), (n_sym * L,)))(
        x, jnp.clip(ds, 0, x.shape[-1] - n_sym * L))
    llr = fsk.mfsk_demodulate_soft(cfg, span)
    out, ok, _ = ldpc_ops.decode(CODE, llr[:, :CODE.n])
    okn = (np.asarray(ok) & np.asarray(found)
           & (np.asarray(out) == info.astype(np.uint8)).all(-1))
    return float(okn.mean())


# (preset, documented operating SNR): mfsk_presets comments; the "reported"
# figures are the GUI's narrowband-pilot convention — all are comfortably
# above the AWGN floor measured here (< -10 dB wideband for every preset).
POINTS = [("mfsk_robust", -12.0), ("mfsk_low_snr", -8.0),
          ("mfsk_medium", -4.0), ("mfsk_fast", 0.0), ("mfsk_turbo", 3.0)]


@pytest.mark.parametrize("preset,snr", POINTS)
def test_preset_loopback_at_operating_point(preset, snr):
    cfg = getattr(fsk, preset)()
    assert _loopback(cfg, snr) == 1.0


def test_tone_count_and_rates():
    """Preset table parity (mfsk.hpp:545-582 + config arithmetic :33-58)."""
    assert [getattr(fsk, p)().num_tones for p, _ in POINTS] == [2, 4, 8, 16, 32]
    cfg = fsk.mfsk_medium()
    assert cfg.bits_per_symbol == 3
    assert cfg.symbol_rate == 31.25
    assert cfg.raw_bps == 93.75
    assert cfg.effective_bps == 46.875
    assert cfg.tone_freq(0) == 1500.0 - 3.5 * 50.0
    assert cfg.tone_freq(7) == 1500.0 + 3.5 * 50.0


def test_cfo_tolerance_without_compensation():
    """Max-power tone detection is inherently CFO-tolerant
    (mfsk.hpp:271-272): 20 Hz offset (< spacing/2) decodes clean."""
    assert _loopback(fsk.mfsk_medium(), -4.0, cfo_hz=20.0) == 1.0


def test_cfo_estimator_parabolic():
    """estimateCFO parity (mfsk.hpp:415-470): recover an applied offset
    from the preamble sweep to sub-spacing accuracy."""
    cfg = fsk.mfsk_medium()
    pre = fsk.mfsk_generate_preamble(cfg)
    B = 2
    sig = np.concatenate([np.zeros((B, 3000), np.float32),
                          np.tile(pre, (B, 1)),
                          np.zeros((B, 2000), np.float32)], axis=-1)
    x = W.apply_cfo_hilbert(jnp.asarray(sig), jnp.asarray([12.0, -9.0]))
    x = W.add_noise_active(jax.random.PRNGKey(0), x, 10.0)
    cfo = np.asarray(fsk.mfsk_estimate_cfo(
        cfg, x, jnp.asarray([3000, 3000], jnp.int32)))
    assert abs(cfo[0] - 12.0) < 5.0
    assert abs(cfo[1] + 9.0) < 5.0


def test_no_false_positive_on_noise():
    cfg = fsk.mfsk_medium()
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 80000)),
                       np.float32) * 0.3
    found, _ = fsk.mfsk_find_preamble(cfg, jnp.asarray(noise))
    assert not np.asarray(found).any()


def test_cfo_estimate_feeds_demod_directly():
    """Wiring contract: mfsk_estimate_cfo's output passed STRAIGHT to
    mfsk_demodulate_soft(cfo_hz=...) must compensate (not double) the
    offset.  Pinned after a sign inversion was caught in review: the
    derotation must shift the received tones DOWN by +cfo."""
    cfg = fsk.mfsk_medium()
    rng = np.random.default_rng(4)
    info = rng.integers(0, 2, (2, CODE.k)).astype(np.float32)
    cw = np.asarray(ldpc_ops.encode(CODE, jnp.asarray(info)))
    pre = fsk.mfsk_generate_preamble(cfg)
    data = np.asarray(fsk.mfsk_modulate(cfg, cw))
    sig = np.concatenate([np.zeros((2, 3000), np.float32),
                          np.tile(pre, (2, 1)), data], axis=-1)
    x = W.apply_cfo_hilbert(jnp.asarray(sig), jnp.asarray([15.0, 15.0]))

    cfo = fsk.mfsk_estimate_cfo(cfg, x, jnp.asarray([3000, 3000], jnp.int32))
    assert abs(float(np.asarray(cfo)[0]) - 15.0) < 5.0
    # 15 Hz discriminates: wrong-sign compensation doubles the
    # offset to 30 Hz (> spacing/2) and BER jumps to ~0.5.
    ds = 3000 + cfg.preamble_samples(2)
    llr = fsk.mfsk_demodulate_soft(cfg, x[:, ds:], cfo_hz=cfo)
    hard = (np.asarray(llr)[:, :CODE.n] < 0).astype(np.uint8)
    ber = float((hard != cw.astype(np.uint8)).mean())
    assert ber < 0.01, ber


def test_partial_preamble_masked_by_valid_len():
    """ADVICE r2: on a zero-padded streaming buffer a partially-arrived
    sweep preamble can clear the 30%-valid and 0.6-score gates (the clamped
    window grid reuses the last window); valid_len must mask those offsets
    until the whole preamble has really arrived."""
    import jax.numpy as jnp
    cfg = fsk.mfsk_medium()
    pre = fsk.mfsk_generate_preamble(cfg)
    full = np.zeros(4 * len(pre), np.float32)
    start = 1000
    full[start:start + len(pre)] = pre
    # Stream state: only 70% of the preamble has arrived, rest is padding.
    arrived = start + int(0.7 * len(pre))
    partial = np.zeros_like(full)
    partial[:arrived] = full[:arrived]
    found, _ = fsk.mfsk_find_preamble(
        cfg, jnp.asarray(partial[None, :]),
        valid_len=jnp.asarray([arrived], np.int32))
    assert not bool(np.asarray(found)[0])
    # Once fully arrived the same call finds it at the right offset.
    found, ds = fsk.mfsk_find_preamble(
        cfg, jnp.asarray(full[None, :]),
        valid_len=jnp.asarray([len(full)], np.int32))
    assert bool(np.asarray(found)[0])
    assert abs(int(np.asarray(ds)[0]) - (start + len(pre))) <= cfg.samples_per_symbol
