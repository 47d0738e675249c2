"""Schmidl-Cox preamble acquisition, batched on device.

Reference: src/ofdm/ofdm_sync.cpp + the SEARCHING state machine in
src/ofdm/demodulator.cpp:462-600.  Batched redesign (SURVEY.md §7 hard
part #1 — "stream sync inside fixed shapes"):

* the reference slides an O(N log N) per-offset routine (window FFT ->
  analytic signal -> half-symbol correlation) every 8 samples; here ONE
  global FFT-Hilbert transform produces the analytic signal and the
  half-symbol correlation P(d) = sum conj(a[d+i]) a[d+i+N/2] at EVERY offset
  via a cumulative-sum sliding window — O(T log T) total;
* plateau confirmation (>=15 of the 8-strided offsets in a 300 window above
  0.90) becomes windowed counts over the same grid;
* LTS fine timing is an FFT matched filter against the passband LTS
  template with a masked argmax over the +-search window.

Deviations (documented): the reference recomputes the analytic signal and
removes DC per N-sample window; we use one global analytic transform with
global DC removal — the same operator modulo window-edge effects, verified
equivalent on the regression operating points.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModemConfig
from ..ofdm import carriers as carriers_mod
from ..ops import mixer as mixer_ops

# DELIBERATE DEVIATION: the reference gates the Schmidl-Cox plateau at 0.90
# (demodulator_constants.hpp:51), which caps coherent OFDM acquisition at
# ~18 dB wideband SNR — the metric's expectation is SNR/(SNR+1), so 15 dB
# tops out near 0.88 and the reference's own "15 dB minimum OFDM" suite
# scores 0/16 against its own code (verified by running its
# test_sync_robustness binary).  0.85 admits 15-16 dB; false positives are
# still rejected by the energy gates here, the LTS matched filter (0.35),
# and the LDPC+magic validation downstream.
PLATEAU_THRESHOLD = 0.85
PLATEAU_SEARCH_WINDOW = 300
MIN_PLATEAU_SAMPLES = 15
SEARCH_STEP = 8


def analytic_signal(samples: jnp.ndarray,
                    X: jnp.ndarray | None = None) -> jnp.ndarray:
    """FFT Hilbert transform over the whole buffer (ofdm_sync.cpp:56-84).
    X: optionally precomputed fft(samples, n_fft) — detect_preamble shares
    one signal FFT between this and the LTS matched filter (the two largest
    ops in Cox acquisition)."""
    T = samples.shape[-1]
    n_fft = 1 << (T - 1).bit_length()
    if X is None:
        X = jnp.fft.fft(samples.astype(jnp.complex64), n=n_fft, axis=-1)
    mult = np.ones(n_fft, np.float32)
    mult[0] = 0.0            # drop DC entirely (reference removes per-window DC)
    mult[1:n_fft // 2] = 2.0
    mult[n_fft // 2 + 1:] = 0.0
    return jnp.fft.ifft(X * jnp.asarray(mult), axis=-1)[..., :T]


def _window_sum(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """[..., T] -> [..., T-w+1] sliding sums, numerically stable.

    A plain global cumsum in float32 loses ~all mantissa bits over 100k+
    samples (window differences of two huge numbers), so sums are computed
    blockwise: with block size w, the window starting at p = b*w + j is
    suffix(block b, j) + prefix(block b+1, j) — every term is a <=w-element
    accumulation.
    """
    T = x.shape[-1]
    nb = -(-T // w)
    pad = nb * w - T
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad + w)])
    xb = xp.reshape(*x.shape[:-1], nb + 1, w)
    pre = jnp.cumsum(xb, axis=-1)                       # prefix sums in block
    total = pre[..., -1:]
    suf = total - jnp.concatenate(
        [jnp.zeros_like(pre[..., :1]), pre[..., :-1]], axis=-1)
    nxt = jnp.concatenate(
        [jnp.zeros_like(pre[..., :1, :]), pre[..., 1:, :]], axis=-2)
    prev_pre = jnp.concatenate(
        [jnp.zeros_like(nxt[..., :1]), nxt[..., :-1]], axis=-1)
    out = (suf[..., :-1, :] + prev_pre[..., 1:, :]).reshape(*x.shape[:-1], -1)
    return out[..., :T - w + 1]


def sc_metric(config: ModemConfig, samples: jnp.ndarray,
              X: jnp.ndarray | None = None):
    """Schmidl-Cox |P|/sqrt(R1 R2) and P at every offset.

    Returns (corr [B, n_off], P [B, n_off]) where offset d corresponds to a
    candidate STS start (the FFT window begins at d + CP).
    """
    N, cp = config.fft_size, config.cyclic_prefix
    half = N // 2
    a = analytic_signal(samples, X)
    u = jnp.conj(a[..., :-half]) * a[..., half:]
    e = jnp.abs(a) ** 2
    P_all = _window_sum(u, half)                       # [..., T-N+1]
    R1_all = _window_sum(e[..., :-half], half)
    R2_all = _window_sum(e[..., half:], half)
    T = samples.shape[-1]
    n_off = T - N - cp + 1
    sl = (Ellipsis, slice(cp, cp + n_off))
    P = P_all[sl]
    R1 = R1_all[sl]
    R2 = R2_all[sl]
    denom = jnp.sqrt(jnp.maximum(R1 * R2, 0.0))
    corr = jnp.where(denom > 1e-10, jnp.abs(P) / jnp.maximum(denom, 1e-30), 0.0)
    return corr, P


@functools.lru_cache(maxsize=None)
def lts_passband_template(config: ModemConfig) -> np.ndarray:
    """Passband LTS template [CP | LTS] mixed at fc (demodulator.cpp:100-134).
    Complex (I + jQ) for phase-invariant magnitude correlation."""
    fd = carriers_mod.lts_freq_domain(config)
    td = np.fft.ifft(fd).astype(np.complex64)
    cp = config.cyclic_prefix
    bb = np.concatenate([td[-cp:], td])
    osc = mixer_ops.osc_fixed(config.center_freq, config.sample_rate, len(bb))
    mixed = bb * osc
    return mixed.astype(np.complex64)  # real=I template, imag=Q template


# Deep-acquisition gates (NOT reference behavior — a capability extension).
# The Schmidl-Cox metric's expectation is ~SNR'/(SNR'+1) with SNR' the
# analytic-signal SNR; the faithful 0.85 plateau gate therefore floors
# coherent OFDM acquisition at ~13-14 dB wideband AWGN.  These gates admit
# candidates down to ~7-8 dB wideband (measured: 24/24 exact-timing
# detections at 8-9 dB, 0/40 fires on pure noise thanks to the energy +
# LTS gates) — but a deep candidate is only BELIEVED after its CW0
# LDPC-decodes with the 0x554C magic (ModemEngine._try_cox_deep), so the
# waterfall of admitted-vs-decoded stays clean.
DEEP_SYNC_THRESHOLD = 0.60
DEEP_PLATEAU_THRESHOLD = 0.62
DEEP_MIN_PLATEAU = 12
DEEP_LTS_THRESHOLD = 0.22


@functools.partial(jax.jit, static_argnames=(
    "config", "sync_threshold", "plateau_threshold", "min_plateau",
    "lts_threshold", "with_deep"))
def detect_preamble(config: ModemConfig, samples: jnp.ndarray,
                    sync_threshold: float = 0.80,
                    plateau_threshold: float = PLATEAU_THRESHOLD,
                    min_plateau: int = MIN_PLATEAU_SAMPLES,
                    lts_threshold: float | None = None,
                    with_deep: bool = False):
    """Batched SEARCHING logic: Schmidl-Cox plateau -> coarse CFO -> LTS fine
    timing (demodulator.cpp:474-599).

    plateau_threshold/min_plateau default to the reference-faithful gates.
    with_deep=True additionally evaluates the DEEP_* gate set on the same
    metric/matched-filter arrays (one dispatch, the heavy FFTs are shared)
    and returns the result under "deep_"-prefixed keys — the engine's
    below-the-floor acquisition pass, validated downstream by an LDPC-magic
    CW0 probe before anything is believed (ModemEngine._try_cox_deep).

    Returns dict of [B] arrays: found, data_start (first data-symbol sample),
    cfo_hz, peak_corr, lts_corr, lts_start.
    """
    B, T = samples.shape
    N, cp = config.fft_size, config.cyclic_prefix
    plen = N + cp

    # ONE signal FFT shared by the S&C analytic transform and the LTS
    # matched filter below (both use the same n_fft).
    n_fft = 1 << int(T - 1).bit_length()
    X = jnp.fft.fft(samples.astype(jnp.complex64), n=n_fft, axis=-1)
    n_off = T - N - cp + 1

    # Energy gate (hasMinimumEnergy, ofdm_sync.cpp:20-50): window energy must
    # exceed 4x the tracked noise floor.  The reference's floor is a RUNNING
    # MINIMUM (init 0.1x first energy, track min, slow upward EMA only within
    # 3x of the floor) — its batch equivalent is min(0.1 * first-window
    # energy, min window energy), NOT a low quantile: a quantile floor reads
    # SIGNAL energy when a long frame fills most of the buffer (a 6 s frame
    # leaves <2% noise offsets) and then zeroes ~30% of the preamble's own
    # plateau windows, killing detection of long frames at ANY SNR (caught
    # by the 400-byte calibration rows).  Silence stays rejected by the
    # 1e-10 absolute clamp and the 40 dB peak-ratio clause below.
    # --- Schmidl-Cox metric + energy gate, evaluated ONLY on the stride-8
    # candidate grid (the reference's coarse loop also steps 8).  The
    # window sums run as 8-sample block pre-reductions + block-grid
    # _window_sum — the chirp detect's block-grid playbook (docs/PERF.md
    # round 3): numerically a different (still <=window-length) summation
    # order, 8x less window-sum traffic, and R1/R2 come from ONE energy
    # window sum (R2[d] == R1[d + N/2]).  Measured on-chip: the full-res
    # sc_metric window sums were 17 of the 30 ms/iter detect budget at
    # B=512, T=19k.
    st = SEARCH_STEP
    half = N // 2
    assert cp % st == 0 and half % st == 0, (cp, half, st)
    a = analytic_signal(samples, X)
    nb = T // st
    ab = a[:, :nb * st].reshape(B, nb, st)
    eb = (ab.real * ab.real + ab.imag * ab.imag).sum(-1)      # [B, nb]
    hb = half // st
    ub = (jnp.conj(ab[:, :nb - hb]) * ab[:, hb:]).sum(-1)     # [B, nb-hb]
    Pb = _window_sum(ub, hb)                                  # P at d = st*k
    Eb = _window_sum(eb, hb)                                  # R1 at d = st*k
    # Energy of the exact FFT window the correlation runs on
    # ([p+cp, p+cp+N)), also on the grid.
    sb = (samples * samples)[:, :nb * st].reshape(B, nb, st).sum(-1)
    Ew = _window_sum(sb, N // st)                             # [B, nb-N/st+1]
    cpb = cp // st
    # gP/gR2 need block index cpb+hb+G-1 <= nb-hb (== Pb bound); Ew shares
    # the same bound since N/st == 2*hb.  For stride-divisible T this
    # equals ceil(n_off / st) exactly (full grid coverage).
    G = min(-(-n_off // st), Pb.shape[-1] - cpb, Ew.shape[-1] - cpb)
    gP = Pb[:, cpb:cpb + G]
    gR1 = Eb[:, cpb:cpb + G]
    gR2 = Eb[:, cpb + hb:cpb + hb + G]
    gdenom = jnp.sqrt(jnp.maximum(gR1 * gR2, 0.0))
    gcorr = jnp.where(gdenom > 1e-10,
                      jnp.abs(gP) / jnp.maximum(gdenom, 1e-30), 0.0)

    e_all = Ew[:, cpb:cpb + G] / N
    floor = jnp.maximum(jnp.minimum(0.1 * e_all[:, :1],
                                    e_all.min(-1, keepdims=True)), 1e-10)
    energy_ok = e_all >= 4.0 * floor
    # Also reject windows >40 dB below the buffer peak: true silence only
    # carries the FFT-Hilbert's numerical ringing, which is tiny but
    # self-correlated (the per-window C++ transform sees exact zeros there).
    energy_ok &= e_all >= 1e-4 * e_all.max(-1, keepdims=True)
    gcorr = jnp.where(energy_ok, gcorr, 0.0)                  # [B, G]

    # 8-strided candidate grid positions in SAMPLE units.
    grid = jnp.arange(G) * st
    win_pts = PLATEAU_SEARCH_WINDOW // SEARCH_STEP + 1
    # Leave room for the full preamble + LTS search beyond the candidate.
    max_start = n_off - 6 * plen - 2 * plen
    idxb = jnp.arange(B)
    rel = jnp.arange(win_pts)

    # LTS fine-timing matched filter (shared by both gate sets): FFT
    # correlation against the passband LTS template (ofdm_sync.cpp:386-466).
    tmpl = lts_passband_template(config)
    L = len(tmpl)
    e_ref = float((np.abs(tmpl) ** 2).sum()) * 0.5
    Tf = jnp.fft.fft(jnp.conj(jnp.asarray(tmpl)), n=n_fft)
    mf = jnp.abs(jnp.fft.ifft(X * jnp.conj(Tf), axis=-1))[:, :T - L + 1]
    energy = _window_sum(samples * samples, L)
    nmf = jnp.where(energy * e_ref > 1e-12,
                    mf / jnp.sqrt(jnp.maximum(energy * e_ref, 1e-30)), 0.0)
    pos = jnp.arange(nmf.shape[-1])[None, :]

    def run_gates(sync_t, plat_t, min_plat, lts_t):
        # Plateau count: in [g, g+300], strided by 8 -> 38 grid points.
        above = (gcorr >= plat_t).astype(jnp.float32)
        counts = _window_sum(above, win_pts)             # [B, G-win+1]
        Gc = counts.shape[-1]
        cand = (gcorr[:, :Gc] > sync_t) & (counts >= min_plat)
        cand = cand & (grid[None, :Gc] < jnp.maximum(max_start, 1))

        found_sc = cand.any(-1)
        first = jnp.argmax(cand, axis=-1)                # first candidate

        # Peak within the plateau window after the first candidate.
        win_idx = jnp.clip(first[:, None] + rel[None, :], 0,
                           gcorr.shape[-1] - 1)
        wcorr = gcorr[idxb[:, None], win_idx]
        peak_rel = jnp.argmax(wcorr, axis=-1)
        gidx = jnp.clip(first + peak_rel, 0, G - 1)
        sync_off = grid[gidx]
        peak_corr = wcorr[idxb, peak_rel]

        # Coarse CFO from P at the sync offset (ofdm_sync.cpp:230-258).
        phase = jnp.angle(gP[idxb, gidx])
        cfo = phase * config.sample_rate / (np.pi * N)
        max_cfo = config.sample_rate / N
        cfo = jnp.clip(cfo, -max_cfo, max_cfo)

        # LTS fine timing around sync_off + 4*plen, search [-3*plen, +plen/2].
        coarse_lts = sync_off + 4 * plen
        win = (pos >= (coarse_lts - 3 * plen)[:, None]) & \
              (pos <= (coarse_lts + plen // 2)[:, None])
        lts_start = jnp.argmax(jnp.where(win, nmf, -1.0),
                               axis=-1).astype(jnp.int32)
        lts_corr = nmf[idxb, lts_start]
        # The two LTS symbols are identical, so the matched filter has a
        # one-symbol ambiguity: under noise/multipath the SECOND symbol's
        # peak can edge out the first, shifting training and data by a full
        # symbol.  If a comparable peak exists one symbol EARLIER (still in
        # the window), prefer it.  (The reference's plain argmax has the
        # same ambiguity.)
        prev_pos = jnp.clip(lts_start - plen, 0, nmf.shape[-1] - 1)
        prev_corr = nmf[idxb, prev_pos]
        prev_in_win = (lts_start - plen) >= (coarse_lts - 3 * plen)
        take_prev = prev_in_win & (prev_corr >= 0.85 * lts_corr)
        lts_start = jnp.where(take_prev, prev_pos, lts_start)
        lts_corr = jnp.where(take_prev, prev_corr, lts_corr)
        lts_ok = lts_corr >= lts_t

        found = found_sc & lts_ok
        data_start = lts_start + 2 * plen   # consume both LTS symbols
        return {"found": found, "data_start": data_start, "cfo_hz": cfo,
                "peak_corr": peak_corr, "lts_corr": lts_corr,
                "lts_start": lts_start, "sync_off": sync_off}

    if lts_threshold is None:
        lts_threshold = 0.05 if config.fft_size >= 1024 else 0.35
    out = run_gates(sync_threshold, plateau_threshold, min_plateau,
                    lts_threshold)
    if with_deep:
        deep_lts = min(DEEP_LTS_THRESHOLD, lts_threshold)
        deep = run_gates(DEEP_SYNC_THRESHOLD, DEEP_PLATEAU_THRESHOLD,
                         DEEP_MIN_PLATEAU, deep_lts)
        out.update({"deep_" + k: v for k, v in deep.items()})
    return out


def hunt_for_codeword(config: ModemConfig, mod, samples, data_start: int,
                      rate=None, cfo_hz: float = 0.0, interleaved: bool = True,
                      offsets=(0, -50, 50, -100, 100, -150, 150)):
    """LDPC-validated timing hunt (huntForCodeword, ofdm_sync.cpp:469-643).

    The reference trial-demodulates one candidate offset at a time and
    accepts the first (in the given priority order) whose LDPC-decoded CW0
    starts with the 0x554C magic.  Here ALL candidate offsets demodulate as
    one batch (offset = batch dim) and one LDPC batch validates them; the
    first match in the reference's offset order wins.

    Args: samples [T] or [1, T] (host array; spans are sliced on the host so
    the hunt never runs eager device ops); data_start nominal
    first-data-sample index; cfo_hz the detection's CFO estimate (the
    constant phase difference between candidate spans is absorbed by the
    pilot-tracked equalizer, so one shared initial phase of 0 suffices).
    Returns (found: bool, best_offset: int | None).
    """
    from ..config import CodeRate, bits_per_symbol
    from ..fec import ldpc as ldpc_mod
    from ..fec.interleave import channel_interleaver
    from ..ofdm import demodulator as demod_mod
    from ..ofdm import pipeline as ofdm_pipeline
    from ..ops import ldpc as ldpc_ops
    from ..utils.bits import bits_to_bytes

    rate = rate or CodeRate.R1_4
    code = ldpc_mod.get_code(rate)
    x = np.asarray(samples).reshape(-1)
    S = ofdm_pipeline.num_data_symbols(config, mod, 1)
    span_len = S * config.symbol_duration

    valid = [o for o in offsets if 0 <= data_start + o
             and data_start + o + span_len <= x.shape[-1]]
    if not valid:
        return False, None
    spans = jnp.asarray(np.stack(
        [x[data_start + o:data_start + o + span_len] for o in valid]))

    llrs, _ = demod_mod.demodulate_presynced(
        config, mod, spans, float(cfo_hz), 0.0,
        training_symbols=0, num_data_symbols=S)
    cm = carriers_mod.carrier_map(config)
    if interleaved:
        ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod),
                                 code.n)
        deint = llrs[:, :code.n][:, jnp.asarray(ci.perm)]
    else:
        deint = llrs[:, :code.n]
    info, ok, _ = ldpc_ops.decode(code, deint)
    info = np.asarray(info)
    ok = np.asarray(ok)
    for i, o in enumerate(valid):
        if ok[i]:
            first = bits_to_bytes(info[i][:16])
            if len(first) >= 2 and first[0] == 0x55 and first[1] == 0x4C:
                return True, o
    return False, None


def decode_ofdm_cox(config: ModemConfig, mod, samples: jnp.ndarray,
                    n_codewords: int, sync_threshold: float = 0.80,
                    front: str = "analytic"):
    """Full streaming OFDM_COX RX for aligned-batch frames: detect preamble,
    then demodulate from data_start with unity channel estimate and pilot
    tracking (the streaming path never uses the LTS for channel estimation —
    updateChannelEstimate's first-symbol alpha=1.0 initializes it).

    Assumes all frames in the batch share the same data_start (true for the
    synthetic batched sweeps); returns (llrs [B, nbits], det dict).
    """
    from ..config import bits_per_symbol
    from ..ofdm import demodulator as demod_mod
    from ..ofdm import pipeline as ofdm_pipeline

    det = detect_preamble(config, samples, sync_threshold)
    # Start at the FIRST LTS and treat both LTS symbols as training — the
    # LTS-derived channel estimate then absorbs the CFO phase accumulated
    # since the stream start, leaving only the (small) drift after the LTS.
    # This reuses the chirp path's presynced machinery and is strictly more
    # robust than the reference's streaming path, which discards the LTS for
    # channel estimation and therefore only supports coherent modes at
    # near-zero true CFO (channel_equalizer.cpp:348-363 folds the constant
    # phase back into the equalized symbols via carrier_phase_correction).
    #
    # Mixer bookkeeping: LTS symbols are N+CP long (no symbol guard) and the
    # TX mixer ran [plen, 2*plen) ONCE over the LTS and repeated the buffer,
    # so BOTH received LTS symbols demix at t0 = plen (stride 0) — demixing
    # them at 0 and plen would make the two estimates differ by
    # 2*pi*fc*plen/fs (= pi at the default config) and cancel the pilot
    # average.  Data starts at mixer phase(2*plen) == phase(0).
    start_lts = int(np.asarray(det["lts_start"])[0])
    plen = config.fft_size + config.cyclic_prefix
    S = ofdm_pipeline.num_data_symbols(config, mod, n_codewords)
    # Slice the REAL span on the host (f32 — eager-safe) and let
    # demodulate_span do maybe_analytic + complex slicing inside ONE jit,
    # the same pattern the engine uses (modem/engine.py demod()).  Lead/tail margins (quantized to
    # {0, plen, 2*plen}) keep the Hilbert FFT's wrap discontinuity away
    # from the used symbols (demodulator._edge_tapered).
    end = start_lts + 2 * plen + S * config.symbol_duration
    avail_l, avail_t = start_lts, samples.shape[-1] - end
    lead = 2 * plen if avail_l >= 2 * plen else plen if avail_l >= plen else 0
    tail = 2 * plen if avail_t >= 2 * plen else plen if avail_t >= plen else 0
    span = samples[:, start_lts - lead:end + tail]
    llrs, _ = demod_mod.demodulate_span(config, mod, span, det["cfo_hz"],
                                        0.0, n_lts=2, S=S,
                                        lead=lead, tail=tail, front=front,
                                        n_bits=648 * n_codewords)
    return llrs, det
