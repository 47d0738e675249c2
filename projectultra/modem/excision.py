"""Adaptive narrowband interference excision (beyond-reference).

Real HF channels carry persistent narrowband interferers — broadcast
carriers, CW/RTTY stations, SSB tuning hets — that the reference never
tests or mitigates: a single CW tone at SIR 10 dB (SNR 20 dB) collapses
both OFDM_COX and MC_DPSK streaming decode to ~0/3 (measured round 4,
docs/PERF.md).  Physics: the tone inflates every normalized-correlation
energy window (acquisition gates fail) and parks a max-confidence wrong
line on whichever carriers it straddles.

This module watches the RX stream's spectrum and, when a PERSISTENT
NARROW line dominates the noise floor, inserts streaming IIR notch
biquads (native C cascade, projectultra.native.biquad_cascade —
per-sample recurrences with cross-chunk state are host-runtime work, not
device work) ahead of the modem's buffer.  Design constraints, each load-
bearing:

* PSD updates are gated to NOISE-DOMINATED spans (chunk power within
  QUIET_DB of the running floor): our own waveforms never look like
  lines there, so the detector cannot learn to notch a wanted signal.
  A real interferer persists through inter-frame gaps, which is exactly
  when the floor is measured.
* A line must be NARROW (<= MAX_WIDTH_BINS across its -6 dB extent —
  modulated carriers at the 93.75 Hz symbol rate smear ~+-90 Hz and are
  rejected), STRONG (>= THR_DB over the median in-band bin), and
  PERSISTENT (PERSIST_ON consecutive quiet-span updates) before a notch
  engages; it survives PERSIST_OFF missed updates before release
  (frames parking on top of the tone must not flap the notch).
* At most MAX_TONES notches; each is a RBJ biquad notch of NOTCH_BW_HZ
  (~1.4 carriers of the 512-plan) — removing < 3% of the band, which
  the per-carrier noise estimators already tolerate.
* A tracked tone may DRIFT: a re-detection within TRACK_HZ updates the
  notch frequency in place (hets drift ~Hz/s).

No reference counterpart (modem_rx.cpp feeds raw audio straight to the
demodulators); PARITY.md deviation 18.
"""

from __future__ import annotations

import numpy as np

from ..native import biquad_cascade

FS = 48000.0
FFT_N = 32768                 # 0.68 s window, 1.46 Hz bins
UPDATE_SAMPLES = 24000        # try a PSD update every 0.5 s of audio
BAND_HZ = (150.0, 3400.0)     # only lines inside the modem band matter
THR_DB = 12.0                 # line peak over median in-band bin (refresh)
THR_NEW_DB = 17.0
# NEW candidates need THR_NEW_DB (activation-grade strength).  Harm
# physics: a het at SIR s (vs frame power) in a noise-only window at
# SNR 20 reads (20 - s) + 10*log10(2227 in-band bins / ~12 line bins)
# = (20 - s) + 22.7 dB over the median — any het weak enough to read
# under 17 dB is at SIR >= ~25 and harmless to every decode path, while
# our own narrow features crest at 12-15 dB (the robust-DPSK Barker
# preamble comb at -11 dB under loud noise, measured: the round-4
# detector notched the DPSK carrier and 60%-failed the stream matrix
# row; the SIR-0 burst lines measured 8.6-13 dB).  Tracked tones keep
# refreshing at THR_DB so a drifting or fading het doesn't flap.
# Narrowness gate, the self-notch guard: the slowest shipped waveform line
# is the 31.25-baud DBPSK carrier (psk/dpsk.py robust, 1536 samp/sym) whose
# -6 dB extent is ~37 Hz = 26 bins; 16 bins (23 Hz) rejects it with margin
# while still capturing hets drifting <= ~34 Hz/s across the 0.68 s window.
MAX_WIDTH_BINS = 16
MAX_TONES = 4
# Two-tier activation (round 5, SIR-0 onset).  CLEAN sightings — quiet
# window, near the floor, and every soft-threshold line in the spectrum
# accounted for by tracked/candidate tones (nothing unexplained) — keep
# the round-4 threshold: CLEAN_ON = 2 consecutive.  AMBIGUOUS sightings
# (extra soft lines present, or the window sits above the near-floor
# band) need PERSIST_ON = 4 CONSECUTIVE quiet-update sightings; the
# counter RESETS on a quiet update without the line.  Rationale, all
# measured on tools/test_interferer_onset.py at SIR 0: a short
# control/ACK burst moves the 0.68 s window MEAN by only +0.1-0.4 dB
# (under every power gate) but straddles at most 2 overlapping windows,
# and the leaked 649 Hz false carrier always arrived alongside other
# soft lines — while a real het in a noise-only window is alone and AT
# the floor.  Non-quiet windows (frames in the air) do NOT reset the
# run: a tone hidden under a frame is not evidence of absence.
PERSIST_ON = 4
CLEAN_ON = 2
PERSIST_OFF = 4
TRACK_HZ = 120.0              # same-tone association window
NOTCH_BW_HZ = 60.0
QUIET_DB = 6.0                # window power gate above the running floor
# The quiet floor is a RUNNING MINIMUM of ~0.1 s block powers (same lesson
# as the round-3 Cox energy gate: a low quantile reads signal power on
# frame-dense streams and lets the detector evaluate our own waveforms —
# the OFDM preamble/LTS repetition is a line comb that a percentile floor
# let through to the notches, caught by test_cox_resilience).  MIN_BLOCKS
# of history are required before ANY detection (kills the first-update-
# is-always-quiet hole), and a zero-noise stream has floor ~0 so frame
# audio can never read quiet at all.
BLOCK_SAMPLES = 4800
FLOOR_BLOCKS = 100            # ~10 s forgetting window (gain steps adapt)
MIN_BLOCKS = 20
# Floor STEP-UP (round 5, mid-session onset): when an interferer switches
# ON during an active session, every block reads >= floor + QUIET_DB and
# the quiet gate blocks learning until the pre-onset blocks age out of the
# 100-block history (~10 s of fed audio).  If the last FLOOR_STEP_BLOCKS
# are ALL elevated, the old floor is stale — drop history older than them
# so the floor re-anchors at their minimum (~3 s reaction).  Two guards,
# each load-bearing: (a) frames cannot sustain the condition — any
# inter-frame gap block sits AT the old floor and resets the run (only a
# continuous >= 3 s transmission could, hence (b)); (b) the step is capped
# at FLOOR_STEP_MAX_DB: a zero-noise unit stream has floor ~0, so frame
# blocks are a ~180 dB step and must never re-anchor the floor (the
# round-4 invariant "detection never runs in zero-noise streams"), while
# a real interferer strong enough to matter sits 6-20 dB over the noise.
FLOOR_STEP_BLOCKS = 30
FLOOR_STEP_MAX_DB = 20.0
# Near-floor sighting gate (round 5, SIR-0 onset): a REAL interferer is
# present in every window, including the ones sitting AT the running
# floor (pure tone+noise between bursts); a frame-comb false line only
# ever appears in windows elevated by the frame's own power — at SIR 0
# a full-frame window reads +3 dB over the tone-anchored floor and a
# partial one +1-2 dB, both inside the 6 dB quiet gate.  A NEW tone
# therefore activates only after at least one sighting in a window
# within NEW_LINE_FLOOR_DB of the floor; tracked tones keep refreshing
# through the ordinary quiet gate (drift tracking must survive frame-lit
# windows).  2.0 dB clears the floor statistic's own bias (~0.5 dB: a
# running MIN of 0.1 s block powers sits below a 0.68 s window mean).
#
# The sighting also records the floor LEVEL it was judged against, and is
# REVOKED if the floor later drops more than NEW_LINE_FLOOR_DB below it:
# the floor step-up can re-anchor AT frame+tone level mid-way through a
# LONG frame (MC-DPSK data frames outlast the 3 s step window), which
# makes frame windows read near-floor and leaked one false carrier at
# SIR 0 (the measured 649 Hz flapper).  A frame-anchored floor collapses
# as soon as the frame ends (gap blocks re-anchor the running minimum),
# revoking the contaminated sighting; a real tone's floor holds, and the
# tone re-sights in every gap window anyway.
NEW_LINE_FLOOR_DB = 2.0


def notch_coef(f0_hz: float, bw_hz: float = NOTCH_BW_HZ,
               fs: float = FS) -> np.ndarray:
    """RBJ cookbook notch, a0-normalized [b0, b1, b2, a1, a2]."""
    w = 2.0 * np.pi * f0_hz / fs
    q = f0_hz / bw_hz
    al = np.sin(w) / (2.0 * q)
    a0 = 1.0 + al
    return np.array([1.0 / a0, -2.0 * np.cos(w) / a0, 1.0 / a0,
                     -2.0 * np.cos(w) / a0, (1.0 - al) / a0], np.float64)


class ToneExciser:
    """Streaming narrowband-line detector + notch cascade.

    process(chunk) -> filtered chunk; all state host-side numpy (the
    audio path must not dispatch to the device per chunk — per-dispatch
    latency would dominate real-time streaming).
    """

    def __init__(self, enabled: bool | None = None):
        import os
        if enabled is None:  # ULTRA_EXCISION=0 is the global kill switch
            enabled = os.environ.get("ULTRA_EXCISION", "1") != "0"
        self.enabled = enabled
        self._dbg = os.environ.get("ULTRA_EXCISION_DEBUG") == "1"
        self._fed = 0
        self._win = np.zeros(0, np.float32)   # raw samples for the PSD
        self._since_update = 0
        self._block_acc = 0.0                 # sum of squares, current block
        self._block_n = 0
        self._pow_hist: list[float] = []      # ~0.1 s block powers
        self._window_fn = np.hanning(FFT_N).astype(np.float32)
        self._tones: list[dict] = []          # {f0, on, off, active}
        self._coef = np.zeros((0, 5), np.float64)
        self._state = np.zeros((0, 2), np.float64)
        self.updates = 0
        self.quiet_updates = 0

    # -- public -----------------------------------------------------------

    @property
    def active_tones(self) -> list[float]:
        return [t["f0"] for t in self._tones if t["active"]]

    # Engine RX hints (round 5, the stream-matrix DPSK regression): the
    # demodulator KNOWS when a frame is in the air (pending preamble /
    # in-progress decode) and where it started — spectral gates alone
    # cannot always tell our own waveform from a het (the robust-DPSK
    # R1/4 body is quasi-tonal at 1500 Hz: mostly-zero info bits give a
    # differential carrier with few phase flips, measured 18-24 dB over
    # the median at -11 dB SNR).  While a frame is pending, new-tone
    # ACTIVATION is deferred (tracking continues); when a preamble is
    # detected, tones whose activation post-dates the frame start are
    # revoked (their evidence was the frame's own leading audio — the
    # notch they placed is released before it can cost the decode more
    # than ~1-2 s of body).  A long-standing het activated BEFORE the
    # frame started is never touched.

    def suppress_activation(self, seconds: float):
        self._suppress_fed = max(getattr(self, "_suppress_fed", 0),
                                 self._fed + int(seconds * FS))

    def frame_detected(self, frame_start_abs: int):
        changed = False
        for t in self._tones:
            # An activation strictly BEFORE the frame head drew its
            # evidence from pre-frame windows (each window ends at its
            # activation time) — never touch it.
            if t["active"] and t.get("act_fed", 0) >= frame_start_abs:
                t["active"] = False
                t["on"] = t["clean"] = t["strong"] = 0
                t["floor_seen"] = False
                changed = True
        # Inactive candidates sighted since the frame began were learned
        # from the frame's own audio: restart their evidence.
        self._tones = [t for t in self._tones
                       if t["active"] or t.get("act_fed") is not None
                       or t["on"] == 0]
        for t in self._tones:
            if not t["active"]:
                t["on"] = t["clean"] = t["strong"] = 0
        if changed:
            self._rebuild()

    def process(self, samples: np.ndarray) -> np.ndarray:
        if not self.enabled or not len(samples):
            return samples
        self._accumulate(samples)
        if len(self._coef):
            return biquad_cascade(samples, self._coef, self._state)
        return samples

    # -- detection --------------------------------------------------------

    def _accumulate(self, samples: np.ndarray):
        self._fed += len(samples)
        self._win = np.concatenate([self._win, samples])[-FFT_N:]
        # running-minimum floor over ~0.1 s blocks (every sample counted,
        # so silence/noise gaps anchor the floor even between updates)
        s = samples.astype(np.float64)
        self._block_acc += float((s * s).sum())
        self._block_n += len(s)
        while self._block_n >= BLOCK_SAMPLES:
            self._pow_hist.append(self._block_acc / self._block_n)
            self._pow_hist = self._pow_hist[-FLOOR_BLOCKS:]
            self._block_acc = 0.0
            self._block_n = 0
            # Floor step-up: sustained elevation of the last
            # FLOOR_STEP_BLOCKS (bounded step) means the old floor is
            # stale — see the constant block above for the guards.
            if len(self._pow_hist) >= FLOOR_STEP_BLOCKS + MIN_BLOCKS:
                recent = self._pow_hist[-FLOOR_STEP_BLOCKS:]
                fl = min(self._pow_hist)
                lo = min(recent)
                if (lo > max(fl, 1e-20) * 10 ** (QUIET_DB / 10.0)
                        and lo <= fl * 10 ** (FLOOR_STEP_MAX_DB / 10.0)):
                    self._pow_hist = recent[:]
        self._since_update += len(samples)
        if self._since_update < UPDATE_SAMPLES or len(self._win) < FFT_N:
            return
        self._since_update = 0
        self.updates += 1
        if len(self._pow_hist) < MIN_BLOCKS:
            return
        power = float(np.mean(self._win.astype(np.float64) ** 2))
        floor = min(self._pow_hist)
        if power > max(floor, 1e-20) * 10 ** (QUIET_DB / 10.0):
            # a frame (or burst) is in the air: never learn lines here
            self._miss_all()
            return
        # Window FLATNESS gate: in burst-fed streams (protocol sims feed
        # audio only while the peer transmits) the min-floor itself reads
        # frame-scale, and a window mixing frame slivers with silence can
        # pass the mean-power gate while its preamble/LTS content is a
        # genuine line comb (the NVIS-session self-notch, round 4).
        # Noise(+tone) is flat across 43 ms blocks; frame edges, silence
        # gaps, and impulse bursts are not.
        blk = self._win.astype(np.float64) ** 2
        blk = blk[:(len(blk) // 2048) * 2048].reshape(-1, 2048).mean(1)
        if blk.max() > max(blk.min(), 1e-20) * 10 ** (QUIET_DB / 10.0):
            self._miss_all()
            return
        self.quiet_updates += 1
        near_floor = power <= max(floor, 1e-20) * 10 ** (NEW_LINE_FLOOR_DB
                                                         / 10.0)
        if self._dbg:
            import math
            lines_dbg, _sc_dbg = self._detect_lines()
            print(f"[exc] t={self._fed/48000.0:7.2f}s pow/floor="
                  f"{10*math.log10(power/max(floor,1e-30)):+5.2f}dB "
                  f"nf={int(near_floor)} "
                  f"lines={[(round(f), round(db, 1)) for f, db in lines_dbg]} "
                  f"tones={[(round(t['f0']), t['on'], int(t.get('floor_seen', False)), int(t['active'])) for t in self._tones]}",
                  flush=True)
        # Revoke stale near-floor sightings of still-inactive candidates:
        # the floor they were judged against has collapsed (a long frame
        # ended), so the sighting was frame-contaminated.
        for t in self._tones:
            if (not t["active"] and t.get("floor_seen", False)
                    and floor < t.get("floor_lvl", 0.0)
                    * 10 ** (-NEW_LINE_FLOOR_DB / 10.0)):
                t["floor_seen"] = False
        lines, soft_count = self._detect_lines()
        self._update_tones(lines, near_floor, floor, soft_count)

    def _detect_lines(self, soft_db: float = 4.0):
        """Returns (lines, soft_count): detected tone frequencies plus the
        number of narrow lines above THR_DB - soft_db.  The soft count
        feeds the comb gate: a frame/burst's spectrum can show many
        narrow features of which only 1-2 cross the full threshold
        (measured at SIR 0: a 0.3 s multi-line burst with one 649 Hz
        line at 12+ dB and five more at 6-9 dB taught a false carrier
        that the >= 3-STRONG-lines comb rule never saw).  Noise cannot
        fake the soft threshold: 9-bin smoothing leaves ~1.5 dB std, so
        +8 dB bumps are vanishingly rare — a real 1-2-het environment
        never shows 3 soft lines."""
        x = self._win * self._window_fn
        psd = np.abs(np.fft.rfft(x)) ** 2
        f = np.fft.rfftfreq(FFT_N, 1.0 / FS)
        band = (f >= BAND_HZ[0]) & (f <= BAND_HZ[1])
        # Cross-bin smoothing before the gates: a single periodogram's
        # per-bin estimates fluctuate ~Rayleigh, so a MODULATED carrier's
        # continuous hump sprouts chance 3-bin "lines" that defeat a raw
        # width check (the 31.25-baud DBPSK self-notch near-miss, round 4).
        # A 9-bin moving average cuts the variance ~9x: a true tone's
        # 4-bin mainlobe smears to ~12 bins (inside MAX_WIDTH_BINS), the
        # DBPSK hump resolves to its honest ~26-bin extent (outside).
        k = np.ones(9) / 9.0
        pb = np.convolve(psd[band], k, mode="same")
        fb = f[band]
        med = float(np.median(pb)) + 1e-30
        thr = med * 10 ** (THR_DB / 10.0)
        soft_thr = med * 10 ** ((THR_DB - soft_db) / 10.0)
        lines = []
        soft_count = 0
        order = np.argsort(pb)[::-1]
        taken = np.zeros(len(pb), bool)
        for idx in order:
            if soft_count >= 8:
                break
            if pb[idx] < soft_thr or taken[idx]:
                continue
            # -6 dB extent around the peak must be narrow
            half = pb[idx] / 4.0
            lo = idx
            while lo > 0 and pb[lo - 1] > half:
                lo -= 1
            hi = idx
            while hi < len(pb) - 1 and pb[hi + 1] > half:
                hi += 1
            taken[max(0, lo - MAX_WIDTH_BINS):hi + MAX_WIDTH_BINS] = True
            if hi - lo + 1 > MAX_WIDTH_BINS:
                continue  # modulated carrier / broadband — not a tone
            soft_count += 1
            if pb[idx] < thr or len(lines) >= MAX_TONES:
                continue
            # power-weighted centroid of the extent
            seg = slice(lo, hi + 1)
            f0 = float((fb[seg] * pb[seg]).sum() / pb[seg].sum())
            lines.append((f0, float(10.0 * np.log10(pb[idx] / med))))
        return lines, soft_count

    def _update_tones(self, lines: list[float], near_floor: bool = True,
                      floor: float = 0.0, soft_count: int | None = None):
        if soft_count is None:
            soft_count = len(lines)
        # A comb-contaminated window (>= 3 soft lines — see _detect_lines)
        # is evidence of OUR OWN signal in the air, not of a het: ACTIVE
        # tones still refresh from it (drift tracking must survive framed
        # streams), but INACTIVE candidates treat it as line-absent — the
        # robust-DPSK preamble's 1500+-31.25 Hz Barker comb otherwise
        # ratchets a candidate at the DPSK carrier to activation across
        # frames and notches the waveform's own carrier (the round-4
        # regression that 60%-failed the -11 dB stream matrix row).
        comb = soft_count >= 3
        matched = set()
        hits = []
        for t in self._tones:
            near = [lf for lf in lines if abs(lf[0] - t["f0"]) <= TRACK_HZ]
            if near and (t["active"] or not comb):
                f0, db = min(near, key=lambda lf: abs(lf[0] - t["f0"]))
                matched.add(f0)
                t["f0"] = f0
                t["strong"] = (t.get("strong", 0) + 1 if db >= THR_NEW_DB
                               else 0)
                t["on"] += 1
                t["off"] = 0
                if near_floor and not t.get("floor_seen", False):
                    t["floor_seen"] = True
                    t["floor_lvl"] = floor
                hits.append(t)
            else:
                t["off"] += 1
                if not t["active"]:
                    t["on"] = 0    # consecutiveness: quiet window, line absent
                    t["clean"] = 0
        self._tones = [t for t in self._tones if t["off"] < PERSIST_OFF]
        # Comb rejection (round 5, mid-session onset; soft count added for
        # the SIR-0 burst comb — see _detect_lines): after the floor
        # step-up re-anchors at interferer+noise level, a frame at low SIR
        # sits only a few dB over the new floor and its windows can sneak
        # past the mean/flatness gates — and an OFDM frame's spectrum then
        # presents as SEVERAL simultaneous narrow lines (measured: 3 false
        # 'carriers' learned during a mid-session ARQ storm, each notching
        # a live data carrier and livelocking the transfer).  Real hets
        # arrive 1-2 at a time, so a window showing >= 3 TOTAL lines is
        # comb-contaminated: tracked tones above still refresh from it,
        # but nothing new is learned — the per-NEW-line variant leaked
        # (2 comb lines one update, the third the next, persistence did
        # the rest).  Cost: at most 2 distinct interferer lines can be
        # acquired from any one spectrum; a genuine third-tone onset on
        # top of two tracked tones stays unlearned (measured trade: our
        # own frames must NEVER be notched, MAX_TONES=4 still serves
        # drift tracking and sequential two-tone environments).
        n_new = 0
        if len(lines) <= 2 and soft_count <= 2:
            for f0, db in lines:
                if db < THR_NEW_DB:
                    continue  # activation-grade strength only (THR_NEW_DB)
                if f0 not in matched and len(self._tones) < MAX_TONES:
                    t = {"f0": f0, "on": 1, "off": 0, "active": False,
                         "floor_seen": near_floor, "floor_lvl": floor,
                         "clean": 0, "strong": 1}
                    self._tones.append(t)
                    hits.append(t)
                    n_new += 1
        # CLEAN window: near the floor and no unexplained soft lines
        # (every soft line belongs to a tracked tone or a new candidate).
        clean_win = near_floor and soft_count <= len(matched) + n_new
        for t in hits:
            t["clean"] = t.get("clean", 0) + 1 if clean_win else 0
        suppressed = self._fed < getattr(self, "_suppress_fed", 0)
        for t in hits:
            if (not suppressed
                    and t.get("floor_seen", False) and t.get("strong", 0) >= 1
                    and (t.get("clean", 0) >= CLEAN_ON
                         or t["on"] >= PERSIST_ON)):
                if not t["active"]:
                    t["act_fed"] = self._fed
                t["active"] = True
        self._rebuild()

    def _miss_all(self):
        for t in self._tones:
            if not t["active"]:
                t["off"] += 1  # unconfirmed candidates decay through bursts
        self._tones = [t for t in self._tones if t["off"] < PERSIST_OFF]
        self._rebuild()

    def _rebuild(self):
        # rebuild coefficients; carry state rows for tones that persist
        want = [t["f0"] for t in self._tones if t["active"]]
        new_coef = np.stack([notch_coef(f0) for f0 in want]) if want \
            else np.zeros((0, 5), np.float64)
        if new_coef.shape == self._coef.shape and np.allclose(
                new_coef, self._coef):
            return
        old_n = len(self._coef)
        new_state = np.zeros((len(want), 2), np.float64)
        n = min(old_n, len(want))
        if n:
            new_state[:n] = self._state[:n]
        self._coef = new_coef
        self._state = new_state
