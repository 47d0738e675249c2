"""Decision-directed LMS/RLS adaptive equalizer A/B
(channel_equalizer.cpp:705-727 update rules, :773-801 equalize path,
types.hpp:170-174 config flags).

A/B scenario: coherent QPSK, NO pilots, 4 codewords (~44 symbols), channel
phase drifting 2 deg/symbol from the first data symbol.  The frozen
training estimate rotates past the QPSK decision boundary around symbol 22
(codewords 3-4 fail); the decision-directed equalizer tracks the drift with
a bounded steady-state lag (~ drift * (1-mu)/mu for LMS) and decodes the
whole frame.  Faithful reference parameters (mu=0.05, lambda=0.99).
"""

import numpy as np
import jax.numpy as jnp
import scipy.signal as sig

from projectultra.config import CodeRate, ModemConfig, Modulation
from projectultra.fec import ldpc
from projectultra.ofdm import demodulator as demod
from projectultra.ofdm import modulator as mod_
from projectultra.ofdm import pipeline as ofdm_pipeline
from projectultra.ops import ldpc as ldpc_ops

DRIFT_DEG_PER_SYM = 2.0
N_CW = 4


def _run(cfg: ModemConfig, drift: float = DRIFT_DEG_PER_SYM,
         n_cw: int = N_CW, seed: int = 3) -> list[bool]:
    """Returns per-codeword LDPC decode success under the phase drift."""
    code = ldpc.get_code(CodeRate.R1_4)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(1, code.k * n_cw)).astype(np.float32)
    cws = jnp.concatenate(
        [ldpc_ops.encode(code, jnp.asarray(info[:, i * code.k:(i + 1) * code.k]))
         for i in range(n_cw)], axis=-1)
    S = ofdm_pipeline.num_data_symbols(cfg, Modulation.QPSK, n_cw)
    tr = mod_.generate_training(cfg, 2)
    data = np.asarray(mod_.modulate(cfg, Modulation.QPSK, cws,
                                    t_offset=2 * cfg.symbol_duration))[0]
    tx = np.concatenate([tr, data]).astype(np.float32)

    # Unit-gain phase ramp on the analytic signal, starting at data start.
    L = cfg.symbol_duration
    t = np.arange(len(tx), dtype=np.float64)
    theta = np.maximum(0.0, t - 2 * L) / L * np.deg2rad(drift)
    z = sig.hilbert(tx.astype(np.float64))
    rx = np.real(z * np.exp(1j * theta)).astype(np.float32)
    rx = rx + rng.normal(0, 2e-3, len(rx)).astype(np.float32)

    llrs, _ = demod.demodulate_presynced(
        cfg, Modulation.QPSK, jnp.asarray(rx[None, :]), 0.0, 0.0,
        training_symbols=2, num_data_symbols=S)
    out = []
    for i in range(n_cw):
        _, ok, _ = ldpc_ops.decode(code, llrs[:, i * code.n:(i + 1) * code.n])
        out.append(bool(np.asarray(ok)[0]))
    return out


def _base_cfg(**kw):
    return ModemConfig(use_pilots=False, modulation=Modulation.QPSK, **kw)


def test_default_path_tracks_phase_drift():
    """Round-4 contract change: every coherent no-pilot mode routes
    through the refined dual-PLL demod (common phase + timing slope,
    added for SRO robustness), so the 2 deg/symbol drift that used to
    kill codewords 3-4 of the frozen-LTS scan path now decodes in full
    WITHOUT the adaptive equalizer.  The frozen-weights failure contrast
    is still pinned by test_dd_flag_actually_gates_updates (adaptive EQ
    on + decision_directed off -> scan path with frozen weights)."""
    assert all(_run(_base_cfg()))


def test_dd_eq_tracks_phase_drift_lms():
    assert all(_run(_base_cfg(adaptive_eq_enabled=True)))


def test_dd_eq_tracks_phase_drift_rls():
    assert all(_run(_base_cfg(adaptive_eq_enabled=True,
                              adaptive_eq_use_rls=True)))


def test_dd_flag_actually_gates_updates():
    """decision_directed=False freezes the weights at the training seed —
    same late-codeword failure as adaptive-off (the flag must gate real
    behavior, VERDICT round-1 item 7)."""
    oks = _run(_base_cfg(adaptive_eq_enabled=True, decision_directed=False))
    assert not oks[-1]


def test_adaptive_eq_no_regression_on_static_channel():
    assert all(_run(_base_cfg(), drift=0.0))
    assert all(_run(_base_cfg(adaptive_eq_enabled=True), drift=0.0))
