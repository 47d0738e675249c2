"""Fused end-to-end OFDM frame pipeline: the headline benchmark workload.

Composes LDPC encode -> channel interleave -> OFDM modulate -> (channel sim)
-> presynced demodulate -> deinterleave -> LDPC decode into single jitted
programs batched over frames.  This is BASELINE.json config #2 ("OFDM
512-FFT DQPSK R1/2 single-frame mod/demod over AWGN") and the unit of the
pipelines/sec/chip benchmark.

The interleave/deinterleave permutations are constant gathers fused by XLA
into the neighbouring ops (ModemEngine applies the ChannelInterleaver per
codeword for OFDM modes — modem_engine.cpp:292-310).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModemConfig, Modulation, CodeRate, bits_per_symbol
from ..fec import ldpc
from ..fec.interleave import channel_interleaver
from ..ops import ldpc as ldpc_ops
from . import carriers as carriers_mod
from . import demodulator as demod_mod
from . import modulator as mod_mod

TRAINING_SYMBOLS = 2  # OFDM_CHIRP uses chirp + 2 LTS (ofdm_chirp_waveform.cpp:110-118)


def _interleave_perms(config: ModemConfig, mod: Modulation):
    cm = carriers_mod.carrier_map(config)
    bps = len(cm.data_idx) * bits_per_symbol(mod)
    ci = channel_interleaver(bps, ldpc.BLOCK_LENGTH)
    return np.asarray(ci.inv), np.asarray(ci.perm)


def num_data_symbols(config: ModemConfig, mod: Modulation,
                     n_codewords: int = 1) -> int:
    cm = carriers_mod.carrier_map(config)
    per_sym = len(cm.data_idx) * bits_per_symbol(mod)
    return -(-(ldpc.BLOCK_LENGTH * n_codewords) // per_sym)


@functools.partial(jax.jit, static_argnames=("config", "mod", "rate"))
def tx_frame(config: ModemConfig, mod: Modulation, rate: CodeRate,
             info_bits: jnp.ndarray) -> jnp.ndarray:
    """[B, k] info bits -> [B, T] passband samples (training + data)."""
    code = ldpc.get_code(rate)
    cw = ldpc_ops.encode(code, info_bits)                     # [B, 648]
    inv, _ = _interleave_perms(config, mod)
    interleaved = cw[:, jnp.asarray(inv)]                     # out[p[i]]=in[i]
    data = mod_mod.modulate(config, mod, interleaved,
                            t_offset=TRAINING_SYMBOLS * config.symbol_duration)
    training = jnp.asarray(mod_mod.generate_training(config, TRAINING_SYMBOLS))
    B = info_bits.shape[0]
    return jnp.concatenate(
        [jnp.broadcast_to(training, (B, training.shape[0])), data], axis=-1)


@functools.partial(jax.jit, static_argnames=("config", "mod", "n_codewords"))
def rx_llrs(config: ModemConfig, mod: Modulation, samples: jnp.ndarray,
            cfo_hz=0.0, initial_phase=0.0, n_codewords: int = 1):
    """[B, T] aligned passband samples -> deinterleaved channel LLRs
    [B * n_codewords, 648], the LDPC decoder's input."""
    S = num_data_symbols(config, mod, n_codewords)
    llrs, _ = demod_mod.demodulate_presynced(
        config, mod, samples, cfo_hz, initial_phase,
        training_symbols=TRAINING_SYMBOLS, num_data_symbols=S)
    _, perm = _interleave_perms(config, mod)
    B = samples.shape[0]
    n = ldpc.BLOCK_LENGTH
    blocks = llrs[:, :n_codewords * n].reshape(B * n_codewords, n)
    # Permutation as a one-hot matmul: exactly one 1.0 per column, so
    # f32-HIGHEST is bit-identical to the gather.
    pmat = np.zeros((n, n), np.float32)
    pmat[np.asarray(perm), np.arange(n)] = 1.0
    return jnp.matmul(blocks, jnp.asarray(pmat),
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("config", "mod", "rate", "n_codewords"))
def rx_frame(config: ModemConfig, mod: Modulation, rate: CodeRate,
             samples: jnp.ndarray, cfo_hz=0.0, initial_phase=0.0,
             n_codewords: int = 1):
    """[B, T] aligned passband samples -> (info_bits [B, k*ncw], ok [B], iters)."""
    code = ldpc.get_code(rate)
    B = samples.shape[0]
    deint = rx_llrs(config, mod, samples, cfo_hz, initial_phase,
                    n_codewords=n_codewords)
    info, ok, iters = ldpc_ops.decode(code, deint)
    info = info.reshape(B, n_codewords * code.k)
    ok = ok.reshape(B, n_codewords).all(-1)
    return info, ok, iters.reshape(B, n_codewords)


def frame_samples(config: ModemConfig, mod: Modulation,
                  n_codewords: int = 1) -> int:
    """Total samples per frame (training + data symbols)."""
    S = num_data_symbols(config, mod, n_codewords)
    return (TRAINING_SYMBOLS + S) * config.symbol_duration


def chirp_ofdm_config(modulation: Modulation = Modulation.DQPSK,
                      rate: CodeRate = CodeRate.R1_2) -> ModemConfig:
    """OFDM_CHIRP waveform config (ofdm_chirp_waveform.cpp:10-31):
    512-FFT, 30 carriers, differential, no pilots."""
    return ModemConfig(fft_size=512, num_carriers=30, modulation=modulation,
                       code_rate=rate, use_pilots=False)
