"""Multi-Carrier DPSK: mid-SNR waveform, batched on device.

Reference: src/psk/multi_carrier_dpsk.hpp.  Batched redesign: the
reference's per-carrier per-sample loops become two real matmuls per
direction against constant [C, L] carrier tables:

  TX: sample[s, i] = sum_c Re(e^{j theta[s,c]} e^{j i w_c}) / C
                   = (cos(theta) @ COS - sin(theta) @ SIN)[s, i] / C
  RX: corr[s, c]   = (1/L) sum_i s[s, i] e^{-j i w_c}
                   = (x @ COS^T - j x @ SIN^T)[s, c] / L

Key semantics preserved (multi_carrier_dpsk.hpp):
* each symbol's carrier phase restarts at 0 (":144 t starts at 0 each symbol");
* DQPSK phase steps {45, 135, -135, -45} deg indexed by the 2-bit word (:207);
* training symbol phases (c * sym) * 90 deg (:127), reference symbol at 0 deg;
* soft bits: conf = |corr| * C * 4, llr0 = conf*sin(phase),
  llr1 = conf*sin(2*phase), clipped +-10 (:452-466);
* CFO correction applied per segment as an analytic-signal rotation with a
  per-segment initial phase (the 2026-01-28 fix, modem_rx_decode.cpp:216-265).
  Deviation: we use the zero-delay FFT Hilbert transform instead of the
  reference's 127-tap FIR (which delays the corrected segment by 63 samples);
  this is strictly more accurate.
* no channel interleaving for DPSK modes (modem_rx_decode.cpp:393).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..sync.chirp import ChirpConfig


@dataclasses.dataclass(frozen=True)
class MCDPSKConfig:
    """(multi_carrier_dpsk.hpp:26-92)"""
    sample_rate: float = 48000.0
    num_carriers: int = 8
    freq_low: float = 500.0
    freq_high: float = 2500.0
    samples_per_symbol: int = 512
    bits_per_symbol: int = 2           # 2 = DQPSK, 1 = DBPSK
    training_symbols: int = 8
    chirp_f_start: float = 300.0
    chirp_f_end: float = 2700.0
    chirp_duration_ms: float = 500.0
    use_dual_chirp: bool = True
    chirp_threshold: float = 0.15
    tx_cfo_hz: float = 0.0

    def carrier_freqs(self) -> np.ndarray:
        n = self.num_carriers
        if n == 1:
            return np.array([(self.freq_low + self.freq_high) / 2.0], np.float64)
        spacing = (self.freq_high - self.freq_low) / (n - 1)
        return self.freq_low + spacing * np.arange(n, dtype=np.float64)

    def chirp_config(self) -> ChirpConfig:
        return ChirpConfig(sample_rate=self.sample_rate,
                           f_start=self.chirp_f_start, f_end=self.chirp_f_end,
                           duration_ms=self.chirp_duration_ms, gap_ms=100.0,
                           use_dual_chirp=self.use_dual_chirp,
                           tx_cfo_hz=self.tx_cfo_hz)

    @property
    def bits_per_mc_symbol(self) -> int:
        return self.num_carriers * self.bits_per_symbol

    @property
    def training_samples(self) -> int:
        return self.training_symbols * self.samples_per_symbol

    @property
    def ref_samples(self) -> int:
        return self.samples_per_symbol


# DQPSK phase-change table indexed by the 2-bit word (hpp:207-210).
DQPSK_PHASES = np.array([np.pi / 4, 3 * np.pi / 4, -3 * np.pi / 4, -np.pi / 4],
                        np.float32)


def _level(n: int) -> MCDPSKConfig:
    return MCDPSKConfig(num_carriers=n)


# Speed-level presets (multi_carrier_dpsk.hpp:704-785).
def level5(): return _level(3)
def level6(): return _level(4)
def level7(): return _level(6)
def level8(): return _level(8)
def level9(): return _level(10)
def level10(): return _level(13)     # ModemEngine default (modem_engine.cpp:73)
def level11_ultra(): return _level(20)
def level12_ultra(): return _level(30)


@functools.lru_cache(maxsize=None)
def _carrier_tables(cfg: MCDPSKConfig):
    """COS/SIN [C, L] tables: cos/sin(i * 2*pi*f_c/fs), float32 constants."""
    freqs = cfg.carrier_freqs()
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = 2.0 * np.pi * freqs[:, None] * i[None, :] / cfg.sample_rate
    return (np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32))


def _synth(cfg: MCDPSKConfig, theta: jnp.ndarray) -> jnp.ndarray:
    """[..., S, C] absolute symbol phases -> [..., S*L] passband samples."""
    COS, SIN = _carrier_tables(cfg)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    out = (ct @ jnp.asarray(COS) - st @ jnp.asarray(SIN)) / cfg.num_carriers
    return out.reshape(*theta.shape[:-2], theta.shape[-2] * cfg.samples_per_symbol)


@functools.lru_cache(maxsize=None)
def generate_training(cfg: MCDPSKConfig) -> np.ndarray:
    """Training: theta[sym, c] = (c*sym)*90deg (hpp:121-150). Host constant.

    ensure_compile_time_eval: the first call for a config may come from
    INSIDE a jit trace (e.g. estimate_snr_db in an RX-only process) where
    omnistaging would turn _synth's output into a tracer and np.asarray
    would raise TracerArrayConversionError."""
    s = np.arange(cfg.training_symbols)[:, None]
    c = np.arange(cfg.num_carriers)[None, :]
    theta = ((c * s) % 4).astype(np.float32) * (np.pi / 2)
    with jax.ensure_compile_time_eval():
        return np.asarray(_synth(cfg, jnp.asarray(theta)[None]))[0]


@functools.lru_cache(maxsize=None)
def generate_reference(cfg: MCDPSKConfig) -> np.ndarray:
    """Reference symbol: all carriers at phase 0 (hpp:154-174)."""
    theta = np.zeros((1, cfg.num_carriers), np.float32)
    with jax.ensure_compile_time_eval():
        return np.asarray(_synth(cfg, jnp.asarray(theta)[None]))[0]


def preamble(cfg: MCDPSKConfig) -> np.ndarray:
    """[CHIRP][TRAINING][REF] (hpp:105-117)."""
    from ..sync import chirp as chirp_mod
    return np.concatenate([chirp_mod.generate(cfg.chirp_config()),
                           generate_training(cfg), generate_reference(cfg)])


@functools.partial(jax.jit, static_argnames=("cfg",))
def modulate(cfg: MCDPSKConfig, bits: jnp.ndarray) -> jnp.ndarray:
    """[B, nbits] {0,1} -> [B, S*L] passband data samples.

    Differential phases accumulate from the reference symbol (phase 0);
    the cumulative sum replaces the reference's sequential complex products
    (hpp:216-221) exactly (phases are exact multiples of 45 deg).
    """
    B, nbits = bits.shape
    bc = cfg.bits_per_symbol
    per_sym = cfg.bits_per_mc_symbol
    S = -(-nbits // per_sym)
    bits = jnp.pad(bits.astype(jnp.int32), ((0, 0), (0, S * per_sym - nbits)))
    words = bits.reshape(B, S, cfg.num_carriers, bc)
    weights = (1 << jnp.arange(bc - 1, -1, -1, dtype=jnp.int32))
    words = (words * weights).sum(-1)                     # [B, S, C]
    if bc == 2:
        steps = jnp.asarray(DQPSK_PHASES)[words]
    else:
        steps = jnp.where(words > 0, jnp.float32(np.pi), 0.0)
    theta = jnp.cumsum(steps, axis=1)                     # ref phase = 0
    return _synth(cfg, theta)


def correlate_symbols(cfg: MCDPSKConfig, samples: jnp.ndarray) -> jnp.ndarray:
    """demodulateOneSymbol batched (hpp:737-753): [..., S*L] -> [..., S, C]
    complex correlations (mean of s * exp(-j i w_c))."""
    COS, SIN = _carrier_tables(cfg)
    L = cfg.samples_per_symbol
    S = samples.shape[-1] // L
    x = samples[..., :S * L].reshape(*samples.shape[:-1], S, L)
    re = x @ jnp.asarray(COS.T) / L
    im = -(x @ jnp.asarray(SIN.T)) / L
    return (re + 1j * im).astype(jnp.complex64)


@functools.partial(jax.jit, static_argnames=("sample_rate", "out_len"))
def apply_cfo_segment(samples: jnp.ndarray, cfo_hz, initial_phase,
                      sample_rate: float = 48000.0,
                      intra_offset=None, out_len: int = 0) -> jnp.ndarray:
    """CFO-correct one segment: analytic signal rotated by
    exp(j*(initial_phase - 2*pi*cfo*i/fs)), real part
    (applyCFOCorrection, hpp:632-659; zero-delay FFT Hilbert).  Jitted:
    the engine calls it from host code.

    intra_offset (with static out_len): the segment arrives OVER-SLICED at
    a block-aligned position r = intra_offset samples EARLY (a per-row
    int32 array), so hot callers can slice on a block grid and pass the
    residue here.  The shift rides the Hilbert
    FFT as a phase ramp e^{+j 2 pi k r / N} (exact circular shift; the
    kept [0, out_len) window stays inside the real data for any
    r <= T - out_len, so the wrap never contaminates it).  In this mode
    the output is the analytic real part even at cfo=0 (identical up to
    f32 FFT roundtrip, ~1e-6); the default path is byte-identical to
    round 2 and remains the golden-parity route."""
    T = samples.shape[-1]
    n_fft = 1 << (T - 1).bit_length()
    x = jnp.fft.fft(samples.astype(jnp.complex64), n=n_fft, axis=-1)
    mult = np.ones(n_fft, np.float32)
    mult[1:n_fft // 2] = 2.0
    mult[n_fft // 2 + 1:] = 0.0
    spec = x * jnp.asarray(mult)
    cfo = jnp.asarray(cfo_hz, jnp.float32)
    if intra_offset is None:
        analytic = jnp.fft.ifft(spec, axis=-1)[..., :T]
        i = jnp.arange(T, dtype=jnp.float32)
        ph = (jnp.asarray(initial_phase, jnp.float32)[..., None]
              - 2.0 * np.pi * cfo[..., None] * i / np.float32(sample_rate))
        out = (analytic * jnp.exp(1j * ph)).real.astype(jnp.float32)
        active = (jnp.abs(cfo) > 0.1)[..., None]
        return jnp.where(active, out, samples)
    k = jnp.arange(n_fft, dtype=jnp.float32)
    r = jnp.asarray(intra_offset, jnp.float32)
    ramp = jnp.exp(1j * (2.0 * np.pi / n_fft) * r[..., None] * k)
    analytic = jnp.fft.ifft(spec * ramp, axis=-1)[..., :out_len]
    i = jnp.arange(out_len, dtype=jnp.float32)
    ph = (jnp.asarray(initial_phase, jnp.float32)[..., None]
          - 2.0 * np.pi * cfo[..., None] * i / np.float32(sample_rate))
    active = (jnp.abs(cfo) > 0.1)[..., None]
    ph = jnp.where(active, ph, 0.0)  # Re(analytic) == input when inactive
    return (analytic * jnp.exp(1j * ph)).real.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("cfg",))
def training_score(cfg: MCDPSKConfig, training: jnp.ndarray) -> jnp.ndarray:
    """Correlation of the received training against the known (c*s)*90deg
    pattern, in [0, 1].  Used to discriminate chirp-only PINGs from frames —
    robust at low SNR, unlike the reference's absolute 0.05 RMS gate
    (modem_rx.cpp:60-67), which misclassifies once the noise floor exceeds it.
    """
    corr = correlate_symbols(cfg, training[..., :cfg.training_samples])
    d = corr[..., 1:, :] * jnp.conj(corr[..., :-1, :])
    mag = jnp.abs(d)
    dn = jnp.where(mag > 1e-12, d / jnp.maximum(mag, 1e-30), 0.0)
    c = jnp.arange(cfg.num_carriers)
    expected = jnp.exp(1j * (c * (np.pi / 2)).astype(jnp.float32))
    s = (dn * jnp.conj(expected)).reshape(*dn.shape[:-2], -1)
    return jnp.abs(s.mean(-1))


@functools.lru_cache(maxsize=None)
def _clean_training_corr(cfg: MCDPSKConfig):
    """Noise-free per-symbol training correlations [S, C] (complex, as a
    real/imag f32 pair): includes the deterministic inter-carrier leakage
    of the non-bin-aligned carriers, so the SNR estimator's residual is
    noise only, not leakage."""
    tr = generate_training(cfg)                        # np [S*L]
    COS, SIN = _carrier_tables(cfg)
    L = cfg.samples_per_symbol
    x = tr.reshape(-1, L).astype(np.float64)
    I = x @ COS.T.astype(np.float64) / L
    Q = -(x @ SIN.T.astype(np.float64)) / L
    return I.astype(np.float32), Q.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_snr_db(cfg: MCDPSKConfig, training: jnp.ndarray) -> jnp.ndarray:
    """Per-carrier post-correlation SNR from the training symbols — the
    reference's getEstimatedSNR semantics (channel_equalizer.cpp:221:
    |H|^2 / per-carrier noise variance, NOT wideband audio SNR; the two
    differ by the correlation processing gain 10*log10(N/(2*C))).

    Least-squares fit of a per-carrier channel gain against the KNOWN
    noise-free training correlations (which include the deterministic
    inter-carrier leakage): the residual is pure noise, so the estimate
    does not saturate at the leakage floor."""
    corr = correlate_symbols(cfg, training[..., :cfg.training_samples])
    cr, ci_ = _clean_training_corr(cfg)
    clean = jax.lax.complex(jnp.asarray(cr), jnp.asarray(ci_))  # [S, C]
    S = corr.shape[-2]
    clean = clean[:S]
    # LS per carrier: h = sum_s z*conj(clean) / sum_s |clean|^2.
    denom = (jnp.abs(clean) ** 2).sum(-2)              # [C]
    h = (corr * jnp.conj(clean)).sum(-2) / jnp.maximum(denom, 1e-12)
    resid = corr - h[..., None, :] * clean
    sig = (jnp.abs(h[..., None, :] * clean) ** 2).mean((-1, -2))
    noise = (jnp.abs(resid) ** 2).mean((-1, -2))
    snr = sig / jnp.maximum(noise, 1e-12)
    return 10.0 * jnp.log10(jnp.clip(snr, 1e-3, 1e5))


def estimate_residual_cfo(cfg: MCDPSKConfig, training: jnp.ndarray) -> jnp.ndarray:
    """processTraining (hpp:392-422): residual CFO from the phase error
    between the first two training symbols vs the expected c*90deg step."""
    corr = correlate_symbols(cfg, training[..., :2 * cfg.samples_per_symbol])
    sym0, sym1 = corr[..., 0, :], corr[..., 1, :]
    c = jnp.arange(cfg.num_carriers)
    expected = jnp.exp(1j * (c * (np.pi / 2)).astype(jnp.float32))
    err = sym1 * jnp.conj(sym0) * jnp.conj(expected)
    avg_err = jnp.angle(err).mean(-1)
    sym_dur = cfg.samples_per_symbol / cfg.sample_rate
    return avg_err / (2.0 * np.pi * sym_dur)


def reference_symbols(cfg: MCDPSKConfig, ref: jnp.ndarray) -> jnp.ndarray:
    """setReference (hpp:424-435): normalized per-carrier correlation."""
    corr = correlate_symbols(cfg, ref[..., :cfg.samples_per_symbol])[..., 0, :]
    mag = jnp.abs(corr)
    return jnp.where(mag > 0.001, corr / jnp.maximum(mag, 1e-30),
                     jnp.complex64(1.0 + 0j))


def demodulate_soft(cfg: MCDPSKConfig, data: jnp.ndarray,
                    prev: jnp.ndarray) -> jnp.ndarray:
    """demodulateSoft (hpp:437-470): [..., S*L] + prev [..., C] ->
    LLRs [..., S*C*bits]."""
    corr = correlate_symbols(cfg, data)                   # [..., S, C]
    mag = jnp.abs(corr)
    normed = jnp.where(mag > 0.0001, corr / jnp.maximum(mag, 1e-30),
                       jnp.complex64(1.0 + 0j))
    prev_chain = jnp.concatenate([prev[..., None, :], normed[..., :-1, :]],
                                 axis=-2)
    diff = normed * jnp.conj(prev_chain)
    phase = jnp.angle(diff)
    phase = jnp.where(phase < 0, phase + 2 * np.pi, phase)
    conf = mag * cfg.num_carriers * 4.0
    if cfg.bits_per_symbol == 2:
        llrs = jnp.stack([conf * jnp.sin(phase), conf * jnp.sin(2.0 * phase)],
                         axis=-1)
    else:
        llrs = (conf * jnp.cos(phase))[..., None]
    llrs = jnp.clip(llrs, -10.0, 10.0)
    return llrs.reshape(*llrs.shape[:-3], -1)


@functools.partial(jax.jit, static_argnames=("cfg", "num_data_symbols"))
def demodulate_presynced(cfg: MCDPSKConfig, samples: jnp.ndarray, cfo_hz,
                         train_start_abs, num_data_symbols: int,
                         intra_offset=None) -> jnp.ndarray:
    """Full presynced MC-DPSK RX for a batch of frames.

    Args:
      samples: [B, T] aligned at TRAINING start
               (layout [TRAINING][REF][DATA...]); with intra_offset, a
               block-aligned OVER-slice whose true training start sits
               intra_offset[b] samples in (tail must extend past the data
               end by at least max(intra_offset)).
      cfo_hz: [B] dual-chirp CFO estimate (trusted; training refinement is
              discarded in the chirp path, modem_rx_decode.cpp:358-369).
      train_start_abs: [B] absolute sample index of the training start in the
              original stream — per-segment CFO initial phases derive from it.
      intra_offset: optional [B] int32 residue of a block-aligned gather —
              absorbed as an FFT phase ramp inside apply_cfo_segment so hot
              callers never pay an unaligned batched gather (the bench's
              acquisition workload; default None is the golden-parity path).
    Returns LLRs [B, num_data_symbols * bits_per_mc_symbol].
    """
    L = cfg.samples_per_symbol
    tr_n, ref_n = cfg.training_samples, cfg.ref_samples
    fs = cfg.sample_rate
    cfo = jnp.asarray(cfo_hz, jnp.float32)
    t0 = jnp.asarray(train_start_abs, jnp.float32)

    def phase_at(abs_pos):
        ph = -2.0 * np.pi * cfo * abs_pos / np.float32(fs)
        return jnp.mod(ph + np.pi, 2 * np.pi) - np.pi

    d0 = tr_n + ref_n
    n_data = num_data_symbols * L
    if intra_offset is None:
        ref_seg = apply_cfo_segment(samples[:, tr_n:tr_n + ref_n], cfo,
                                    phase_at(t0 + tr_n), fs)
        data = apply_cfo_segment(samples[:, d0:d0 + n_data], cfo,
                                 phase_at(t0 + d0), fs)
    else:
        pad = samples.shape[-1] - tr_n - ref_n - n_data
        ref_seg = apply_cfo_segment(samples[:, tr_n:tr_n + ref_n + pad], cfo,
                                    phase_at(t0 + tr_n), fs,
                                    intra_offset=intra_offset, out_len=ref_n)
        data = apply_cfo_segment(samples[:, d0:d0 + n_data + pad], cfo,
                                 phase_at(t0 + d0), fs,
                                 intra_offset=intra_offset, out_len=n_data)
    prev = reference_symbols(cfg, ref_seg)
    return demodulate_soft(cfg, data, prev)


def num_symbols_for_bits(cfg: MCDPSKConfig, nbits: int) -> int:
    return -(-nbits // cfg.bits_per_mc_symbol)
