"""Dual-chirp acquisition: generation + batched matched-filter detection.

Reference: src/sync/chirp_sync.hpp.  Batched redesign per SURVEY.md §7:
the reference slides an O(L) complex correlation across the buffer at a
coarse 48-sample step then refines (chirp_sync.hpp:560-630).  Round 2
evaluated the correlation at EVERY offset with one full-buffer FFT matched
filter; those B x 131072-point FFTs dominated the acquisition-inclusive
benchmark.

Round 3 exploits the chirp's bandwidth: it occupies only ~2.4 kHz of the
48 kHz sample rate, so the matched filter is computed on a complex-baseband
DECIMATED signal (mix to f_center, 128-tap anti-alias FIR as one strided
conv, keep every 8th sample) — ~10x less FFT work — and every candidate
is then REFINED at full rate with a direct windowed correlation, so reported
positions/correlations keep round-2 exactness:

* the anti-alias FIR only needs to suppress frequencies that FOLD ONTO the
  template band under decimation (>= ~3.2 kHz): the real signal's negative-
  frequency image lands off-template where the matched filter ignores it,
  and the normalization energy is computed at FULL rate;
* decimated correlation magnitudes are rescaled to the full-rate numerator
  scale (kappa = full-rate template self-correlation / decimated one) and
  normalized by the full-rate sliding window energy, so thresholds keep
  their round-2 meaning.  Grid sampling can read a peak up to ~7% low
  (D=8 against the ~20-sample correlation main lobe), so candidate masks
  use 0.93*threshold and the final accept gate uses the refined full-rate
  peak value against the caller's threshold;
* candidate selection (earliest-frame A/B resolve), down-chirp validation,
  CFO recovery, and next_up capping are unchanged in semantics.

CFO physics (chirp_sync.hpp:326-345): a frequency offset shifts the up-chirp
correlation peak by -CFO*fs/k samples and the down-chirp peak by +CFO*fs/k
(k = 4800 Hz/s), so CFO = gap_error / (2 * fs/k) and the true positions are
recovered by applying the opposite shifts.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

# Opt-in bf16 inputs for the acquisition hot path (ULTRA_CHIRP_BF16=1):
# the full-rate refine matmuls and the polyphase decimation conv run with
# bf16 operands + f32 accumulation.  Default OFF — tests pin the f32
# path's round-2 exactness contract (test_chirp_fast_parity.py), and it
# is refused on the GPU (_refuse_bf16_on_gpu).  The coarse FFT matched
# filter stays f32 (bf16 FFTs are neither supported nor wanted), so only
# threshold-margin quantities are affected.
import os as _os
_BF16 = _os.environ.get("ULTRA_CHIRP_BF16") == "1"


def _refuse_bf16_on_gpu():
    """Raise if the bf16 switch is on and JAX's backend is a GPU.

    On an H100 the bf16 detection program, as XLA builds it by default,
    did not finish for some batch shapes ([1, 65536], [4, 65536] and
    [64, 65536]) and ran for others ([16, 65536], bench.py's 256 buffers).
    Built without split-K autotuning (--xla_gpu_enable_split_k_autotuning
    =false) or without Triton GEMMs it ran, so a split-K Triton GEMM in
    the bf16 program is the likely place it stops; which one was not
    isolated.  The f32 path ran in every phase of chip_smoke.py."""
    if _BF16 and jax.default_backend() == "gpu":
        raise RuntimeError(
            "ULTRA_CHIRP_BF16=1 is refused on the GPU: the bf16 chirp "
            "detection program does not finish for some batch shapes")


def _refine_dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    if _BF16:
        return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


@dataclasses.dataclass(frozen=True)
class ChirpConfig:
    """(chirp_sync.hpp:26-36)"""
    sample_rate: float = 48000.0
    f_start: float = 300.0
    f_end: float = 2700.0
    duration_ms: float = 500.0
    gap_ms: float = 100.0
    amplitude: float = 0.5
    tx_cfo_hz: float = 0.0
    use_dual_chirp: bool = True

    @property
    def chirp_samples(self) -> int:
        return int(self.sample_rate * self.duration_ms / 1000.0)

    @property
    def gap_samples(self) -> int:
        return int(self.sample_rate * self.gap_ms / 1000.0)

    @property
    def total_samples(self) -> int:
        if self.use_dual_chirp:
            return 2 * self.chirp_samples + 2 * self.gap_samples
        return self.chirp_samples + self.gap_samples

    @property
    def chirp_rate(self) -> float:
        return (self.f_end - self.f_start) / (self.duration_ms / 1000.0)

    @property
    def cfo_to_samples(self) -> float:
        """Peak shift per Hz of CFO: fs / k = 10 samples/Hz."""
        return self.sample_rate / self.chirp_rate


MAX_REASONABLE_CFO_HZ = 100.0

# Decimation factor for the coarse matched-filter search.  The chirp band
# (300-2700 Hz +-100 Hz CFO) fits comfortably in fs/8 = 6 kHz complex
# baseband, and the D=8 grid samples the ~20-sample-wide (fs/BW) main
# correlation lobe densely enough that the worst-case grid read is ~7% low.
DECIM = 8
DECIM_TAPS = 128
# Candidate masks compensate the worst-case grid sampling loss; the final
# accept gate re-tests the refined full-rate peak against the true threshold.
GRID_LOSS = 0.93
REFINE_HALF = 12  # full-rate refine window half-width (> D + parabolic slop)


def _phase_up(cfg: ChirpConfig, t: np.ndarray, cfo: float = 0.0) -> np.ndarray:
    return 2.0 * np.pi * ((cfg.f_start + cfo) * t + 0.5 * cfg.chirp_rate * t * t)


def _phase_down(cfg: ChirpConfig, t: np.ndarray, cfo: float = 0.0) -> np.ndarray:
    return 2.0 * np.pi * ((cfg.f_end + cfo) * t - 0.5 * cfg.chirp_rate * t * t)


@functools.lru_cache(maxsize=None)
def generate(cfg: ChirpConfig) -> np.ndarray:
    """TX chirp sequence: [up][gap][down][gap] (chirp_sync.hpp:59-105)."""
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    out = np.zeros(cfg.total_samples, dtype=np.float32)
    out[:cfg.chirp_samples] = cfg.amplitude * np.sin(
        _phase_up(cfg, t, cfg.tx_cfo_hz))
    if cfg.use_dual_chirp:
        d0 = cfg.chirp_samples + cfg.gap_samples
        out[d0:d0 + cfg.chirp_samples] = cfg.amplitude * np.sin(
            _phase_down(cfg, t, cfg.tx_cfo_hz))
    return out


@functools.lru_cache(maxsize=None)
def _templates(cfg: ChirpConfig):
    """Analytic (cos + j*sin) templates + energies, host constants."""
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    pu = _phase_up(cfg, t)
    pd = _phase_down(cfg, t)
    up = (np.cos(pu) + 1j * np.sin(pu)).astype(np.complex64)
    down = (np.cos(pd) + 1j * np.sin(pd)).astype(np.complex64)
    e_up = float((np.sin(pu).astype(np.float32) ** 2).sum())
    e_down = float((np.sin(pd).astype(np.float32) ** 2).sum())
    return up, down, e_up, e_down


@functools.lru_cache(maxsize=None)
def _decim_filter(cfg: ChirpConfig):
    """Complex band-select decimation kernel as two real tap rows [2, K].

    w[k] = h[k] * e^{-j 2 pi fc (k - K//2) / fs}, h = Kaiser lowpass.  The
    per-output-sample residual rotation e^{+j 2 pi fc m D / fs} cancels in
    the signal-vs-template correlation (both sides carry it), so it is never
    applied.  Stopband only needs to cover fold-onto-template-band sources
    (|f - fc| >= fs/D - bw, i.e. >= ~3.2 kHz real frequency): the real
    signal's image band is harmless off-template content."""
    fs = cfg.sample_rate
    fc = 0.5 * (cfg.f_start + cfg.f_end)
    bw = 0.5 * (cfg.f_end - cfg.f_start) + MAX_REASONABLE_CFO_HZ
    assert fs / DECIM >= 4.0 * bw / 1.8, "decimated rate too low for band"
    K = DECIM_TAPS
    k = np.arange(K, dtype=np.float64)
    m = k - (K - 1) / 2.0
    cut = (bw + (fs / DECIM - 2 * bw) * 0.5) / (fs / 2.0)  # mid transition
    h = np.sinc(cut * m) * cut * np.kaiser(K, 9.0)
    h /= h.sum()  # unity DC (baseband) gain
    ph = -2.0 * np.pi * fc * (k - K // 2) / fs
    w = np.stack([h * np.cos(ph), h * np.sin(ph)]).astype(np.float32)
    return w  # [2, K]: real/imag tap rows


def _decimate(cfg: ChirpConfig, samples: jnp.ndarray) -> jnp.ndarray:
    """[B, T] real -> [B, ceil(T/D)] complex baseband at fs/D.

    Polyphase formulation: the D-strided 128-tap conv is re-expressed as a
    stride-1 conv over the BLOCK axis of x reshaped to [B, D, T/D] — D input
    channels (sample phase), kernel width K/D — a form XLA lowered better
    than a stride-8 conv on the original target (not measured on a GPU).
    y[m] = sum_j sum_ph w[D*j+ph] x[D*(m+j-K/(2D)) + ph]."""
    w = _decim_filter(cfg)
    K = w.shape[1]
    D = DECIM
    B, T = samples.shape
    Tb = -(-T // D)
    xp = jnp.pad(samples, ((0, 0), (0, Tb * D - T)))
    xb = xp.reshape(B, Tb, D).transpose(0, 2, 1)        # [B, D(phase), Tb]
    kw = K // D
    kern = jnp.asarray(w.reshape(2, kw, D).transpose(0, 2, 1))  # [2, D, kw]
    if _BF16:
        out = jax.lax.conv_general_dilated(
            xb.astype(jnp.bfloat16), kern.astype(jnp.bfloat16),
            window_strides=(1,),
            padding=((kw // 2, kw - 1 - kw // 2),),
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=jnp.float32)         # [B, 2, Tb]
    else:
        out = jax.lax.conv_general_dilated(
            xb, kern, window_strides=(1,),
            padding=((kw // 2, kw - 1 - kw // 2),),
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=jax.lax.Precision.HIGHEST)        # [B, 2, Tb]
    return out[:, 0, :] + 1j * out[:, 1, :]


@functools.lru_cache(maxsize=None)
def _templates_dec(cfg: ChirpConfig):
    """Decimated complex-baseband templates (host, numpy — same filter as
    the signal path) + the kappa scale mapping decimated correlation
    magnitudes onto the full-rate numerator scale."""
    _, _, e_up, e_down = _templates(cfg)
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    w = _decim_filter(cfg).astype(np.float64)
    wk = w[0] + 1j * w[1]
    K = len(wk)
    P = K // 2

    def dec(x):
        xp = np.concatenate([np.zeros(P), x, np.zeros(P - 1 + (-len(x)) % DECIM)])
        n_out = (len(xp) - K) // DECIM + 1
        idx = np.arange(n_out)[:, None] * DECIM + np.arange(K)[None, :]
        return (xp[idx] * wk[None, :]).sum(-1)

    up_d = dec(np.sin(_phase_up(cfg, t)))
    dn_d = dec(np.sin(_phase_down(cfg, t)))
    # kappa: a clean unit chirp's decimated self-correlation must read as
    # the full-rate numerator e_up (resp. e_down).
    k_up = e_up / float(np.abs((up_d * np.conj(up_d)).sum()))
    k_dn = e_down / float(np.abs((dn_d * np.conj(dn_d)).sum()))
    return (up_d.real.astype(np.float32), up_d.imag.astype(np.float32), k_up,
            dn_d.real.astype(np.float32), dn_d.imag.astype(np.float32), k_dn)


@functools.lru_cache(maxsize=None)
def _refine_mats(cfg: ChirpConfig):
    """Shifted-template matrices for the full-rate refine as ONE dense
    matmul per candidate set (in place of a 24000-wide conv kernel with 25
    outputs).

    Kc [W, 2*(2R+1)]: column j holds cos(template) shifted j rows down,
    column (2R+1)+j holds -sin(template) shifted j — so seg @ Kc yields
    Re / -Im of sum s[p+i]*conj(tmpl[i]) at the 2R+1 offsets.
    Ke [W, 2R+1]: ones-window shifts — (seg*seg) @ Ke yields window energy.
    """
    up, down, _, _ = _templates(cfg)
    L = cfg.chirp_samples
    R = REFINE_HALF
    W = L + 2 * R
    n_off = 2 * R + 1

    def shifts(vec):
        m = np.zeros((W, n_off), np.float32)
        for j in range(n_off):
            m[j:j + L, j] = vec
        return m

    kc_up = np.concatenate([shifts(up.real.astype(np.float32)),
                            shifts(-up.imag.astype(np.float32))], 1)
    kc_dn = np.concatenate([shifts(down.real.astype(np.float32)),
                            shifts(-down.imag.astype(np.float32))], 1)
    ke = shifts(np.ones(L, np.float32))
    return kc_up, kc_dn, ke


# Gather alignment for the bf16 refine path.  The batched dynamic-slice
# gather of [B*K, 24024] f32 is nearly all of the refine stage's cost (the
# matmuls are FLOP-trivial), and a block-aligned gather was the faster form
# on the original target (not yet measured on a GPU).  So in bf16 mode the
# refine gathers 128-aligned blocks and absorbs the intra-block offset into
# EXTRA shifted-template matmul columns (n_q = 193 placements instead of
# 25), selecting each row's 25 live columns afterwards — trading matmul
# FLOPs for the gather's fixed cost.  f32 keeps the tight dense path: its matmul cost
# would grow ~8x (slow on the CPU test backend) and it is the exactness-
# contract path.
REFINE_ALIGN = 128


@functools.lru_cache(maxsize=None)
def _refine_mats_aligned(cfg: ChirpConfig, which: str):
    """Extended shifted-template matrices for the block-aligned bf16 refine.

    Column q of kc holds the template placed q rows down the WA-long
    gathered window (q in [0, n_q)); a candidate whose window starts r
    samples into the gathered block range selects columns [r, r+2R].
    Returns (kc [WA, 2*n_q] bf16, ke [WA, n_q] bf16, WA, n_q)."""
    import ml_dtypes
    up, down, _, _ = _templates(cfg)
    tmpl = up if which == "up" else down
    L = cfg.chirp_samples
    R = REFINE_HALF
    W = L + 2 * R
    A = REFINE_ALIGN
    WA = -(-(W + A - 1) // A) * A
    n_q = WA - W + 2 * R + 1

    def shifts(vec, n):
        m = np.zeros((WA, n), np.float32)
        for j in range(n):
            m[j:j + L, j] = vec
        return m

    kc = np.concatenate([shifts(tmpl.real.astype(np.float32), n_q),
                         shifts(-tmpl.imag.astype(np.float32), n_q)], 1)
    ke = shifts(np.ones(L, np.float32), n_q)
    return (kc.astype(ml_dtypes.bfloat16), ke.astype(ml_dtypes.bfloat16),
            WA, n_q)


def _corr_dense(cfg: ChirpConfig, samples: jnp.ndarray, start: jnp.ndarray,
                mats, e_t: float):
    """f32 path: per-candidate [W]-gather + dense [W, 2*(2R+1)] matmuls."""
    B, T = samples.shape
    L = cfg.chirp_samples
    R = REFINE_HALF
    W = L + 2 * R
    K = start.shape[1]
    seg = jax.vmap(lambda b, st: jax.vmap(
        lambda s: jax.lax.dynamic_slice(b, (s,), (W,)))(st)
    )(samples, start)                                    # [B, K, W]
    seg2 = seg.reshape(B * K, W)
    kc, ke = mats
    n_off = 2 * R + 1
    num = _refine_dot(seg2, jnp.asarray(kc))                # [B*K, 2*(2R+1)]
    mag = jnp.sqrt(num[:, :n_off] ** 2 + num[:, n_off:] ** 2)
    en = _refine_dot(seg2 * seg2, jnp.asarray(ke))          # [B*K, 2R+1]
    denom = jnp.sqrt(jnp.maximum(en * e_t, 0.0))
    return jnp.where(denom > 1e-10, mag / denom, 0.0)


def _corr_aligned(cfg: ChirpConfig, samples: jnp.ndarray, start: jnp.ndarray,
                  which: str, e_t: float):
    """bf16 path: 128-aligned block gather + extended-column matmuls.

    Gathered windows may run into the zero-padded tail, but every SELECTED
    column q <= r + 2R only reads rows < start + W - block_start <= T -
    block_start, i.e. real samples; padded rows only feed unselected
    columns."""
    B, T = samples.shape
    L = cfg.chirp_samples
    R = REFINE_HALF
    W = L + 2 * R
    A = REFINE_ALIGN
    kc, ke, WA, n_q = _refine_mats_aligned(cfg, which)
    K = start.shape[1]
    nblk = WA // A
    # Pad two extra blocks so block starts never clamp (WA - W < 2A).
    Tb = -(-T // A) + 2
    rb = jnp.pad(samples, ((0, 0), (0, Tb * A - T))) \
        .reshape(B, Tb, A).astype(jnp.bfloat16)
    stb = start // A                                     # [B, K], fits by pad
    seg = jax.vmap(lambda b, st: jax.vmap(
        lambda s: jax.lax.dynamic_slice(b, (s, 0), (nblk, A)))(st)
    )(rb, stb)                                           # [B, K, nblk, A]
    seg2 = seg.reshape(B * K, WA)
    r = (start - stb * A).reshape(B * K)                 # intra-block offset
    num = jnp.dot(seg2, jnp.asarray(kc),
                  preferred_element_type=jnp.float32)    # [B*K, 2*n_q]
    en = jnp.dot(seg2 * seg2, jnp.asarray(ke),
                 preferred_element_type=jnp.float32)     # [B*K, n_q]
    rows = jnp.arange(start.size)[:, None]
    sel = r[:, None] + jnp.arange(2 * R + 1)[None, :]    # live columns
    mag = jnp.sqrt(num[rows, sel] ** 2 + num[rows, n_q + sel] ** 2)
    denom = jnp.sqrt(jnp.maximum(en[rows, sel] * np.float32(e_t), 0.0))
    return jnp.where(denom > 1e-10, mag / denom, 0.0)


def _refine_full(cfg: ChirpConfig, samples: jnp.ndarray, pos: jnp.ndarray,
                 mats, e_t: float, which: str = ""):
    """Exact normalized correlation around candidates: direct windowed
    correlation at EVERY full-rate offset in [pos-R, pos+R], peak argmax +
    parabolic sub-sample interpolation rounded back to int
    (chirp_sync.hpp:607-620 semantics).

    pos may be [B] or [B, K] (K candidates per row, e.g. the A/B resolver
    rules — ONE [B*K, W] matmul instead of K dispatch groups); returns
    (pos, corr) with pos's shape."""
    B, T = samples.shape
    L = cfg.chirp_samples
    R = REFINE_HALF
    W = L + 2 * R
    squeeze = pos.ndim == 1
    posk = pos[:, None] if squeeze else pos              # [B, K]
    K = posk.shape[1]
    start = jnp.clip(posk - R, 0, max(T - W, 0))
    if _BF16 and which and T >= W:
        corr = _corr_aligned(cfg, samples, start, which, e_t)
    else:
        corr = _corr_dense(cfg, samples, start, mats, e_t)

    idx = jnp.arange(B * K)
    j = jnp.argmax(corr, axis=-1).astype(jnp.int32)
    c1 = corr[idx, j]
    # Parabolic interpolation on the full-rate neighbors, rounded to int.
    jm = jnp.clip(j - 1, 0, 2 * R)
    jp = jnp.clip(j + 1, 0, 2 * R)
    c0 = corr[idx, jm]
    c2 = corr[idx, jp]
    den = 2.0 * (c0 - 2.0 * c1 + c2)
    delta = jnp.where(jnp.abs(den) > 1e-10,
                      jnp.clip((c0 - c2) / jnp.where(jnp.abs(den) > 1e-10,
                                                     den, 1.0), -1.0, 1.0),
                      0.0)
    interior = (j >= 1) & (j <= 2 * R - 1)
    jr = jnp.where(interior, jnp.round(j + delta).astype(jnp.int32), j)
    outp = (start.reshape(B * K) + jr).astype(jnp.int32).reshape(B, K)
    outc = c1.reshape(B, K)
    if squeeze:
        return outp[:, 0], outc[:, 0]
    return outp, outc


def _window_sum_dec(samples: jnp.ndarray, L: int, n_pos_d: int) -> jnp.ndarray:
    """Full-rate L-sample sliding energy, evaluated on the D grid only.

    When L is a DECIM multiple (every shipped config) the grid-aligned
    window sums are EXACT sums of T/D pre-reduced D-sample block energies,
    so the sliding sum runs on the 8x-shorter block array (through the same
    block-stable _window_sum — a flat f32 cumsum difference is the
    precision trap documented in CLAUDE.md).  Otherwise fall back to the
    full-rate path and subsample."""
    from projectultra.sync.schmidl_cox import _window_sum
    D = DECIM
    if L % D:
        return _window_sum(samples * samples, L)[:, ::D][:, :n_pos_d]
    B, T = samples.shape
    Tb = T // D
    blocks = (samples[:, :Tb * D].reshape(B, Tb, D) ** 2).sum(-1)
    return _window_sum(blocks, L // D)[:, :n_pos_d]


@functools.partial(jax.jit, static_argnames=("cfg", "threshold"))
def detect_dual_chirp(cfg: ChirpConfig, samples: jnp.ndarray,
                      threshold: float = 0.15):
    """Batched detectDualChirp (chirp_sync.hpp:349-505).

    Args:  samples [B, T] float32.
    Returns dict of arrays: success [B] bool, cfo_hz [B], up_chirp_start [B],
    down_chirp_start [B], up/down correlation [B].
    """
    _refuse_bf16_on_gpu()
    B, T = samples.shape
    L = cfg.chirp_samples
    gap = cfg.gap_samples
    D = DECIM
    up_re, up_im, k_up, dn_re, dn_im, k_dn = _templates_dec(cfg)
    _, _, e_up, e_down = _templates(cfg)
    kc_up, kc_dn, ke = _refine_mats(cfg)

    # --- coarse search on the decimated grid (one FFT ~10x smaller than
    # the round-2 full-buffer matched filter)
    xd = _decimate(cfg, samples)                        # [B, Td] complex
    Td = xd.shape[-1]
    n_pos = T - L + 1                                   # full-rate positions
    n_pos_d = (n_pos + D - 1) // D                      # D-grid positions
    L_d = len(up_re)
    n_fft = 1 << int(Td - 1).bit_length()
    S = jnp.fft.fft(xd, n=n_fft, axis=-1)

    # Both templates ride ONE batched inverse FFT ([B, 2, n_fft] — one
    # kernel call instead of two, full-rate numerator scale via kappa).
    t_up = jnp.asarray(up_re) + 1j * jnp.asarray(up_im)
    t_dn = jnp.asarray(dn_re) + 1j * jnp.asarray(dn_im)
    Tf2 = jnp.fft.fft(jnp.stack([t_up, t_dn]), n=n_fft, axis=-1)  # [2, n_fft]
    c2 = jnp.fft.ifft(S[:, None, :] * jnp.conj(Tf2)[None], axis=-1)
    num_up = jnp.abs(c2[:, 0, :n_pos_d]) * k_up
    num_dn = jnp.abs(c2[:, 1, :n_pos_d]) * k_dn
    energy = _window_sum_dec(samples, L, n_pos_d)       # full-rate energy
    den_up = jnp.sqrt(jnp.maximum(energy * e_up, 0.0))
    den_dn = jnp.sqrt(jnp.maximum(energy * e_down, 0.0))
    corr_up = jnp.where(den_up > 1e-10, num_up / den_up, 0.0)  # [B, n_pos_d]
    corr_dn = jnp.where(den_dn > 1e-10, num_dn / den_dn, 0.0)
    if _BF16:
        # The candidate-selection glue (masks/argmax chains over
        # [B, n_pos_d]) is lowering-bound; bf16 coarse correlations halve
        # its bytes.  Threshold-margin quantities only: every accept gate
        # re-tests the refined full-rate f32 peak, and a bf16-induced
        # one-cell candidate shift stays inside the +-12-sample refine
        # capture window (parity suite runs with the flag on).
        corr_up = corr_up.astype(jnp.bfloat16)
        corr_dn = corr_dn.astype(jnp.bfloat16)

    pos_d = jnp.arange(n_pos_d)
    # Reference searches pos < samples.size() - L (exclusive of last).
    search_mask = pos_d * D < (T - L)
    cu = jnp.where(search_mask[None, :], corr_up, -1.0)
    idxb = jnp.arange(B)
    c2s = cfg.cfo_to_samples
    thr_grid = GRID_LOSS * threshold

    def up_candidate(strong):
        """Earliest strong crossing -> local grid peak (+-512 full-rate)."""
        first = jnp.argmax(strong, axis=-1).astype(jnp.int32)
        rel = jnp.arange(-512 // D, 512 // D + 1)
        widx = jnp.clip(first[:, None] + rel[None, :], 0, n_pos_d - 1)
        wc = cu[idxb[:, None], widx]
        return widx[idxb, jnp.argmax(wc, axis=-1)].astype(jnp.int32)

    def down_candidate(up_pos):
        """Down-chirp search window (chirp_sync.hpp:420-438), full-rate
        arithmetic masked onto the D grid."""
        start = up_pos + L // 2
        expected = up_pos + L + gap
        end = jnp.minimum(T, expected + 2 * L)
        end = jnp.where(end <= start + L, jnp.minimum(T, start + 2 * L), end)
        pfull = pos_d[None, :] * D
        dn_mask = (pfull >= start[:, None]) & (pfull + L <= end[:, None]) \
            & (pfull < (T - L))
        cd = jnp.where(dn_mask, corr_dn, -1.0)
        down_pos_d = jnp.argmax(cd, axis=-1).astype(jnp.int32)
        return down_pos_d, cd[idxb, down_pos_d]

    # EARLIEST chirp wins, not the globally strongest: with several frames
    # in one buffer a global argmax would lock onto a later chirp and
    # discard everything before it.  Two candidate rules, validated by the
    # full up+down+CFO chain:
    #   A: earliest above the ABSOLUTE threshold — keeps a genuinely weak
    #      (faded) early frame that a relative floor would skip;
    #   B: earliest above max(threshold, 0.7*global max) — robust when A's
    #      first crossing is a noise spike whose down-chirp never matches.
    # A wins when it fully validates; otherwise fall back to B.  Both
    # rules' refines run as ONE K=2 batched matmul group.
    gmax = cu.max(-1)
    strong_a = cu >= thr_grid
    strong_b = cu >= jnp.maximum(thr_grid, 0.7 * gmax[:, None])
    upd2 = jnp.stack([up_candidate(strong_a), up_candidate(strong_b)], 1)
    up_pos2, up_corr2 = _refine_full(cfg, samples, upd2 * D, (kc_up, ke),
                                     e_up, which="up")      # [B, 2]
    any2 = jnp.stack([strong_a.any(-1), strong_b.any(-1)], 1)
    up_found2 = any2 & (up_corr2 >= threshold)

    dnd_a, dng_a = down_candidate(up_pos2[:, 0])
    dnd_b, dng_b = down_candidate(up_pos2[:, 1])
    dnd2 = jnp.stack([dnd_a, dnd_b], 1)
    down_pos2, down_corr2 = _refine_full(cfg, samples, dnd2 * D,
                                         (kc_dn, ke), e_down, which="down")
    down_grid2 = jnp.stack([dng_a, dng_b], 1)
    down_found2 = (down_grid2 >= thr_grid) & (down_corr2 >= threshold)

    # CFO from gap error (10 samples/Hz sensitivity).
    gap_error2 = (down_pos2 - up_pos2 - (L + gap)).astype(jnp.float32)
    cfo_hz2 = gap_error2 / (2.0 * c2s)
    cfo_ok2 = jnp.abs(cfo_hz2) <= MAX_REASONABLE_CFO_HZ
    success2 = up_found2 & down_found2 & cfo_ok2

    use_a = success2[:, 0]
    sel = jnp.where(use_a, 0, 1)

    def pick2(arr2):
        return arr2[idxb, sel]

    success = pick2(success2)
    up_pos = pick2(up_pos2)
    up_corr = pick2(up_corr2)
    down_pos = pick2(down_pos2)
    down_corr = pick2(down_corr2)
    down_found = pick2(down_found2)
    cfo_hz = pick2(cfo_hz2)
    strong = jnp.where(use_a[:, None], strong_a, strong_b)

    # First strong up-chirp crossing AFTER the chosen one (next frame's
    # chirp): consumers cap buffer consumption there so a mis-sized consume
    # can never eat a following frame's preamble.
    later = strong & (pos_d[None, :] * D >= (up_pos + L)[:, None])
    has_next = later.any(-1)
    # The D-grid crossing can read up to D-1 samples late; bias the cap
    # EARLY (consumers use it as an upper bound on consumption — leaving a
    # few extra samples unconsumed is harmless, eating into the next
    # frame's chirp is not).
    next_up = jnp.where(
        has_next,
        jnp.maximum(jnp.argmax(later, axis=-1) * D - (D - 1), 0),
        -1).astype(jnp.int32)

    up_start = jnp.round(up_pos + cfo_hz * c2s).astype(jnp.int32)
    down_start = jnp.round(down_pos - cfo_hz * c2s).astype(jnp.int32)

    # Earliest strong up-template crossing regardless of validation — a
    # PARTIALLY-ARRIVED chirp (down chirp still streaming in) fails the
    # full up+down+CFO chain but already correlates strongly; consumers use
    # this to avoid consuming into an arriving chirp (e.g. the engine's
    # Cox false-positive fail path).  Biased early like next_up.
    any_strong = (cu >= thr_grid).any(-1)
    first_strong = jnp.where(
        any_strong,
        jnp.maximum(jnp.argmax(cu >= thr_grid, axis=-1) * D - (D - 1), 0),
        -1).astype(jnp.int32)

    return {
        "success": success,
        "first_strong_up": first_strong,
        "cfo_hz": jnp.where(success, cfo_hz, 0.0),
        "up_chirp_start": up_start,
        "down_chirp_start": down_start,
        "up_correlation": up_corr,
        "down_correlation": jnp.where(down_found, down_corr, 0.0),
        "next_up_start": next_up,
    }


def training_start(cfg: ChirpConfig, down_chirp_start) -> jnp.ndarray:
    """Training begins after [down chirp][gap] (ofdm_chirp_waveform.cpp:155-160)
    — computed from the down-chirp position, which is more accurate under CFO."""
    return down_chirp_start + cfg.chirp_samples + cfg.gap_samples


def initial_cfo_phase(cfg: ChirpConfig, cfo_hz, train_start) -> jnp.ndarray:
    """Accumulated CFO-correction phase at the training start
    (ofdm_chirp_waveform.cpp:180-190), wrapped to [-pi, pi]."""
    phase = -2.0 * np.pi * cfo_hz * train_start.astype(jnp.float32) / cfg.sample_rate
    return jnp.mod(phase + np.pi, 2.0 * np.pi) - np.pi
