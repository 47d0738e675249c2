"""Batched OFDM modulator: coded bits -> 48 kHz passband audio, on device.

Batched JAX rework of src/ofdm/modulator.cpp.  Differences from the C++ by
design, with identical output semantics:

* the whole frame batch [B, ...] is modulated in one fused XLA program —
  bit gather -> constellation gather -> scatter to FFT grid -> batched IFFT
  -> CP concat -> analytic NCO upmix;
* differential encoding is a cumulative phase-index sum over the symbol
  axis (exact on the {1,j,-1,-j} grid) instead of a sequential complex
  multiply chain;
* the NCO is an analytic phase ramp (ops/mixer.py), not an incremental
  accumulator.

Sample-layout parity (modulator.cpp:348-580):
  modulate():   per symbol [CP | IFFT(N) | guard zeros], mixer continuous
  preamble():   [silence N+CP | 4x STS(N+CP) | 2x LTS(N+CP)], mixer reset at
                STS start, silence does NOT advance the mixer
  training(c):  c x [CP | LTS | guard], mixer reset at start
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModemConfig, Modulation, bits_per_symbol, is_differential
from ..ops import mixer as mixer_ops
from . import carriers as carriers_mod
from . import constellations as con


def _ifft_cp(freq_domain: jnp.ndarray, cp: int) -> jnp.ndarray:
    """[..., N] freq -> [..., CP+N] time with cyclic prefix."""
    td = jnp.fft.ifft(freq_domain, axis=-1).astype(jnp.complex64)
    return jnp.concatenate([td[..., -cp:], td], axis=-1)


def map_bits_to_symbols(config: ModemConfig, mod: Modulation,
                        bits: jnp.ndarray) -> jnp.ndarray:
    """[B, nbits] {0,1} -> [B, S, C] complex constellation symbols.

    Bit consumption order matches modulator.cpp:374-451: bc bits per carrier
    MSB-first, carriers in order, then next symbol; trailing bits padded with
    zeros.
    """
    cm = carriers_mod.carrier_map(config)
    C = len(cm.data_idx)
    bc = bits_per_symbol(mod)
    B, nbits = bits.shape
    per_sym = C * bc
    S = -(-nbits // per_sym)
    pad = S * per_sym - nbits
    bits = jnp.pad(bits.astype(jnp.int32), ((0, 0), (0, pad)))
    words = bits.reshape(B, S, C, bc)
    weights = (1 << jnp.arange(bc - 1, -1, -1, dtype=jnp.int32))
    words = (words * weights).sum(-1)  # [B, S, C]

    # Carriers whose bits lie entirely past the input are left EMPTY (complex
    # zero), matching modulator.cpp:453-456 — only partially-filled carriers
    # get zero-bit padding.
    first_bit = (np.arange(S * C).reshape(S, C)) * bc
    filled = jnp.asarray(first_bit < nbits)[None, :, :]

    if mod == Modulation.DBPSK:
        cum = jnp.cumsum(words, axis=1) % 2
        syms = jnp.where(cum == 0, 1.0 + 0j, -1.0 + 0j).astype(jnp.complex64)
    elif mod == Modulation.DQPSK:
        cum = jnp.cumsum(words, axis=1) % 4
        syms = jnp.asarray(con.DQPSK_PHASES)[cum]
    elif mod == Modulation.D8PSK:
        # Cumulative angle: each step is word*45deg + 22.5deg.
        ang = words.astype(jnp.float32) * (np.pi / 4) + np.pi / 8
        cum = jnp.cumsum(ang, axis=1)
        syms = (jnp.cos(cum) + 1j * jnp.sin(cum)).astype(jnp.complex64)
    else:
        syms = jnp.asarray(con.table(mod))[words]
    return jnp.where(filled, syms, jnp.complex64(0.0))


@functools.lru_cache(maxsize=None)
def _synthesis_tensors(config: ModemConfig, t_offset: int, S: int):
    """Host-constant sparse OFDM synthesis: carrier symbols -> passband.

    The FD grid has only len(data_idx)+len(pilot_idx) nonzero bins, so the
    IFFT + CP + guard + NCO upmix collapse into one small [S, C, L] tensor
    contraction.  Returns (Ar, Ai [S, C, L]
    f32, pilot_wave [S, L] f32 or None); out = sr@Ar - si@Ai + pilot_wave.
    """
    cm = carriers_mod.carrier_map(config)
    N, cp, guard = config.fft_size, config.cyclic_prefix, config.symbol_guard
    sym_len = config.symbol_duration
    L = sym_len
    n_idx = (np.arange(L) - cp) % N
    live = np.arange(L) < cp + N                          # guard -> zeros

    def carrier_rows(idx) -> np.ndarray:                  # [len(idx), L]
        rows = np.exp(2j * np.pi * np.outer(np.asarray(idx, np.float64),
                                            n_idx) / N) / N
        return np.where(live[None, :], rows, 0.0)

    osc = mixer_ops.osc_fixed(
        config.center_freq + config.tx_cfo_hz, config.sample_rate,
        S * sym_len, offset=t_offset).reshape(S, sym_len)

    A = carrier_rows(cm.data_idx)[None, :, :] * osc[:, None, :] \
        * config.output_scale                              # [S, C, L]
    pilot_wave = None
    if config.use_pilots and len(cm.pilot_idx):
        p = (np.asarray(cm.pilot_seq)[:, None]
             * carrier_rows(cm.pilot_idx)).sum(0)          # [L]
        pilot_wave = (p[None, :] * osc).real.astype(np.float32) \
            * config.output_scale
    return (A.real.astype(np.float32), A.imag.astype(np.float32),
            pilot_wave)


def symbols_to_passband(config: ModemConfig, syms: jnp.ndarray,
                        t_offset: int = 0) -> jnp.ndarray:
    """[B, S, C] constellation symbols -> [B, S*sym_len] float32 passband.

    Pilots inserted from the fixed pilot sequence; mixer phase continuous
    from sample index t_offset (relative to the last mixer reset)."""
    B, S, C = syms.shape
    Ar, Ai, pilot_wave = _synthesis_tensors(config, t_offset, S)
    hi = jax.lax.Precision.HIGHEST  # full f32 products and accumulation
    out = jnp.einsum("bsc,scl->bsl", syms.real, jnp.asarray(Ar),
                     precision=hi) \
        - jnp.einsum("bsc,scl->bsl", syms.imag, jnp.asarray(Ai),
                     precision=hi)
    if pilot_wave is not None:
        out = out + jnp.asarray(pilot_wave)[None]
    return out.reshape(B, S * config.symbol_duration).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("config", "mod", "t_offset"))
def modulate(config: ModemConfig, mod: Modulation, bits: jnp.ndarray,
             t_offset: int = 0) -> jnp.ndarray:
    """Batched OFDMModulator::modulate — [B, nbits] -> [B, samples]."""
    syms = map_bits_to_symbols(config, mod, bits)
    return symbols_to_passband(config, syms, t_offset)


@functools.lru_cache(maxsize=None)
def _training_np(config: ModemConfig, count: int) -> np.ndarray:
    """LTS training block (generateTrainingSymbols, modulator.cpp:534-580):
    count x [CP | LTS | guard], mixer reset at start.  Constant, so computed
    once on host."""
    lts_fd = carriers_mod.lts_freq_domain(config)
    td = np.fft.ifft(lts_fd).astype(np.complex64)
    cp = config.cyclic_prefix
    one = np.concatenate([td[-cp:], td])
    sym_len = config.symbol_duration
    out = np.zeros(count * sym_len, dtype=np.float32)
    for c in range(count):
        t0 = c * sym_len
        osc = mixer_ops.osc_fixed(config.center_freq + config.tx_cfo_hz,
                                  config.sample_rate, len(one), offset=t0)
        out[t0:t0 + len(one)] = (one * osc).real * config.output_scale
    return out


def generate_training(config: ModemConfig, count: int) -> np.ndarray:
    """Training symbols for chirp-based acquisition; data modulation then
    continues at t_offset = count * symbol_duration."""
    return _training_np(config, count)


@functools.lru_cache(maxsize=None)
def generate_preamble(config: ModemConfig) -> np.ndarray:
    """Schmidl-Cox preamble (generatePreamble, modulator.cpp:479-531):
    silence(N+CP) + 4x STS + 2x LTS; constant per config.

    Quirk preserved from the reference: STS is mixed ONCE (t in [0, N+CP))
    and the identical buffer is repeated 4x; LTS is mixed once at
    t in [N+CP, 2(N+CP)) and repeated 2x.  The mixer therefore advances only
    2 symbol lengths over the whole preamble; modulate() continues from
    there (preamble_data_t_offset)."""
    N, cp = config.fft_size, config.cyclic_prefix
    plen = N + cp
    scale = config.output_scale
    fc = config.center_freq + config.tx_cfo_hz

    def sym_to_real(fd: np.ndarray, t0: int) -> np.ndarray:
        td = np.fft.ifft(fd).astype(np.complex64)
        one = np.concatenate([td[-cp:], td])
        osc = mixer_ops.osc_fixed(fc, config.sample_rate, plen, offset=t0)
        return ((one * osc).real * scale).astype(np.float32)

    sts = sym_to_real(carriers_mod.sts_freq_domain(config), 0)
    lts = sym_to_real(carriers_mod.lts_freq_domain(config), plen)
    return np.concatenate([np.zeros(plen, np.float32)] + [sts] * 4 + [lts] * 2)


def preamble_data_t_offset(config: ModemConfig) -> int:
    """Mixer sample index at which modulate() continues after the preamble
    (the reference mixer advances only one STS + one LTS; see
    generate_preamble)."""
    return 2 * (config.fft_size + config.cyclic_prefix)


def samples_per_symbol(config: ModemConfig) -> int:
    return config.symbol_duration


def bits_per_ofdm_symbol(config: ModemConfig, mod: Modulation) -> int:
    cm = carriers_mod.carrier_map(config)
    return len(cm.data_idx) * bits_per_symbol(mod)
