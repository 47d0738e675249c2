#!/usr/bin/env python
"""HF reality soak — realistic receiver audio through ONE engine.

Reference: tools/test_hf_reality.cpp:1-17 (continuous noise floor from
sample 0, variable leading silence, random inter-frame gaps, TX ramp
up/down, mixed modulation modes).  This port is STRICTER than the
reference's harness: the C++ decodes an oracle window around each KNOWN
frame position with a fresh demodulator; here the whole stream feeds ONE
ModemEngine in audio-callback-sized chunks with the normal poll cadence and
no position oracle (docs/TESTING_METHODOLOGY anti-cheat rules).

Stream contents: OFDM_COX data frames (DQPSK R1/2), chirp-led MC-DPSK data
frames, and a chirp PING, every frame with a 25 ms cosine TX ramp, random
0.7-1.3x inter-frame gaps, 2-4 s leading noise-only audio, continuous noise
floor at --snr (vs mean in-frame signal power, the reference's definition).

Second phase: a --soak-minutes pure-noise soak through the same engine —
zero events required (the false-decode gate the stale hardware recordings
cannot provide).

Usage: python tools/test_hf_reality.py [--snr 25] [--frames 12]
           [--duration 60] [--soak-minutes 10] [--cpu] [--quick]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def tx_ramp(audio, n=1200):
    """25 ms cosine ramp on both edges (test_hf_reality.cpp applyTxRamp)."""
    import numpy as np
    if len(audio) < 2 * n:
        return audio
    w = 0.5 * (1.0 - np.cos(np.pi * np.arange(n) / n))
    out = audio.copy()
    out[:n] *= w
    out[-n:] *= w[::-1]
    return out


def run(snr_db=25.0, num_frames=12, duration_sec=60.0, soak_minutes=10.0,
        chunk=960, verbose=True, sro_ppm=0.0):
    import numpy as np
    from projectultra.config import Modulation, CodeRate
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol import frame_v2 as F
    from projectultra.protocol.frame_v2 import WaveformMode

    rng = np.random.default_rng(42)

    def make_tx(wf):
        e = ModemEngine()
        e.set_waveform_mode(wf)
        e.connect_waveform = wf
        e.connected = True
        e.handshake_complete = True
        e.data_modulation = Modulation.DQPSK
        e.data_code_rate = CodeRate.R1_2
        return e

    tx_cox = make_tx(WaveformMode.OFDM_COX)
    tx_mc = make_tx(WaveformMode.MC_DPSK)

    # --- build the stream: frames at random positions over continuous noise
    msgs = [f"MSG{i}_HF_TEST" for i in range(num_frames)]
    frame_audio = []
    for i, msg in enumerate(msgs):
        tx = tx_cox if i % 2 == 0 else tx_mc
        fb = F.DataFrame.make_data("W1AW", "VE3ABC", i, msg).serialize()
        frame_audio.append(tx_ramp(tx.transmit(fb)))
    ping_audio = tx_ramp(tx_mc.transmit_ping())

    total = int(duration_sec * 48000)
    stream = np.zeros(total, np.float32)
    avg_gap = duration_sec / (num_frames + 2)
    t = float(rng.uniform(2.0, 4.0))  # leading noise-only audio
    positions = []
    placed = list(frame_audio) + [ping_audio]
    for audio in placed:
        pos = int(t * 48000)
        if pos + len(audio) > total:
            stream = np.concatenate(
                [stream, np.zeros(pos + len(audio) + 48000 - total,
                                  np.float32)])
            total = len(stream)
        stream[pos:pos + len(audio)] += audio
        positions.append(pos)
        t += len(audio) / 48000.0 + avg_gap * float(rng.uniform(0.7, 1.3))

    if sro_ppm:
        # Compound impairment: the whole mixed-waveform stream through a
        # skewed RX clock (tools/test_sro.py apply_sro), BEFORE the noise
        # (the RX ADC samples channel noise at its own clock, so noise
        # statistics are unchanged by the resample).
        import importlib.util
        _spec = importlib.util.spec_from_file_location(
            "sro_tool", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "test_sro.py"))
        _sro = importlib.util.module_from_spec(_spec)
        _spec.loader.exec_module(_sro)
        stream = _sro.apply_sro(stream, sro_ppm)

    sig_power = float(np.mean(np.concatenate(placed) ** 2))
    noise_std = float(np.sqrt(sig_power / 10 ** (snr_db / 10.0)))
    stream = stream + rng.normal(0, noise_std, len(stream)).astype(np.float32)

    # --- ONE engine, chunked feed, no oracle
    rx = make_tx(WaveformMode.OFDM_COX)
    got, pings = [], []
    rx.on_frame = got.append
    rx.on_ping = pings.append
    fed = 0
    for i in range(0, len(stream), chunk):
        rx.feed_audio(stream[i:i + chunk])
        fed += chunk
        if fed % 4800 < chunk:
            rx.poll()
    rx.feed_audio(np.zeros(8000, np.float32))
    rx.poll()

    texts = []
    for fr in got:
        df = F.DataFrame.deserialize(fr.frame_bytes)
        if df:
            texts.append(df.payload_as_text())
    missing = [m for m in msgs if m not in texts]
    extra = [x for x in texts if x not in msgs]
    if verbose:
        print(f"frames decoded: {len(texts)}/{num_frames}  "
              f"pings: {len(pings)}/1")
        for m in missing:
            print(f"  MISSING: {m}")
        for x in extra:
            print(f"  UNEXPECTED: {x!r}")
    phase1 = not missing and not extra and len(pings) == 1

    # --- pure-noise false-decode soak (bigger chunks: the soak gates false
    # events, not callback cadence)
    soak_samples = int(soak_minutes * 60 * 48000)
    rx2 = make_tx(WaveformMode.OFDM_COX)
    events = []
    rx2.on_frame = events.append
    rx2.on_ping = events.append
    soak_chunk = 48000
    left = soak_samples
    while left > 0:
        n = min(soak_chunk, left)
        rx2.feed_audio(rng.normal(0, noise_std, n).astype(np.float32))
        rx2.poll()
        left -= n
    if verbose:
        print(f"noise soak: {soak_minutes:.1f} min, "
              f"false events: {len(events)}")
    phase2 = len(events) == 0

    # --- phase 3: impulse-noise + clipping torture (round-4, VERDICT r3
    # next #8).  Real HF has static crashes and ADC saturation the
    # Watterson sim never produces; the stale reference recordings leave
    # synthetic torture as the only real-world proxy
    # (TESTING_METHODOLOGY anti-cheat rules — one engine, no oracle).
    #
    # Injections into the SAME composite stream construction:
    #   * inter-frame static crashes: 10-40 ms bursts at 15x the noise std
    #     in every gap between frames — all frames must still decode
    #     (adjacent-frame recovery), zero false decodes;
    #   * one mid-frame crash on a sacrificial frame — that frame may die,
    #     its neighbors must not;
    #   * hard clipping of the whole stream at 85% of peak (transmit/ADC
    #     saturation) on top.
    rng3 = np.random.default_rng(1234)
    tortured = stream.copy()
    crash_events = 0
    for k in range(len(positions) - 1):
        end_k = positions[k] + len(placed[k])
        start_next = positions[k + 1]
        gap = start_next - end_k
        if gap < 24000:
            continue
        n = int(rng3.uniform(0.010, 0.040) * 48000)
        at = end_k + int(rng3.uniform(0.2, 0.7) * (gap - n))
        tortured[at:at + n] += rng3.normal(
            0, 15 * noise_std, n).astype(np.float32)
        crash_events += 1
    sacrifice = num_frames // 2
    mid = positions[sacrifice] + len(placed[sacrifice]) // 2
    n = int(0.030 * 48000)
    tortured[mid:mid + n] += rng3.normal(
        0, 15 * noise_std, n).astype(np.float32)
    clip = 0.85 * float(np.abs(tortured).max())
    tortured = np.clip(tortured, -clip, clip)

    rx3 = make_tx(WaveformMode.OFDM_COX)
    got3, pings3 = [], []
    rx3.on_frame = got3.append
    rx3.on_ping = pings3.append
    fed = 0
    for i in range(0, len(tortured), chunk):
        rx3.feed_audio(tortured[i:i + chunk])
        fed += chunk
        if fed % 4800 < chunk:
            rx3.poll()
    rx3.feed_audio(np.zeros(8000, np.float32))
    rx3.poll()
    texts3 = []
    for fr in got3:
        df = F.DataFrame.deserialize(fr.frame_bytes)
        if df:
            texts3.append(df.payload_as_text())
    extra3 = [x for x in texts3 if x not in msgs]
    required = [m for i, m in enumerate(msgs) if i != sacrifice]
    missing3 = [m for m in required if m not in texts3]
    if verbose:
        print(f"impulse torture: {crash_events} gap crashes + 1 mid-frame "
              f"+ clip@85%: decoded {len(texts3)}/{num_frames} "
              f"(sacrificial #{sacrifice} "
              f"{'survived' if msgs[sacrifice] in texts3 else 'lost, ok'}), "
              f"false={len(extra3)}")
        for m in missing3:
            print(f"  MISSING (non-sacrificial): {m}")
    phase3 = not missing3 and not extra3

    # --- phase 3b: STRONG static crashes mid-frame (round-4, impulse
    # blanker showcase).  Phase 3's 15x-noise-std crash sits ~1.5 dB BELOW
    # frame power at SNR 25 — envelope-undetectable, the sacrificial frame
    # may die.  Here every frame takes a 30 ms crash at +15 dB over MEAN
    # IN-FRAME power (a close lightning strike; raw decode collapses to
    # ~1/4 at this level, docs/PERF.md) plus the same gap crashes, and the
    # blanker (modem/blanker.py) must carry ALL frames + the ping through
    # with zero false decodes.
    rng3b = np.random.default_rng(4321)
    tough = stream.copy()
    for k, audio in enumerate(placed[:-1]):  # data frames, not the ping
        mid = positions[k] + int(0.5 * len(audio))
        n = 1440
        # +15 dB over the power of the frame it HITS (the all-frame mean
        # under-scales crashes on the hotter OFDM frames to ~+11 dB —
        # at the blanker threshold, fragmenting the run)
        crash_std = float(np.sqrt(np.mean(audio ** 2) * 10 ** (15.0 / 10.0)))
        tough[mid:mid + n] += rng3b.normal(0, crash_std, n).astype(np.float32)
    for k in range(len(positions) - 1):
        end_k = positions[k] + len(placed[k])
        gap = positions[k + 1] - end_k
        if gap < 24000:
            continue
        n = int(rng3b.uniform(0.010, 0.040) * 48000)
        at = end_k + int(rng3b.uniform(0.2, 0.7) * (gap - n))
        tough[at:at + n] += rng3b.normal(0, 15 * noise_std, n).astype(np.float32)
    rx3b = make_tx(WaveformMode.OFDM_COX)
    got3b, pings3b = [], []
    rx3b.on_frame = got3b.append
    rx3b.on_ping = pings3b.append
    fed = 0
    for i in range(0, len(tough), chunk):
        rx3b.feed_audio(tough[i:i + chunk])
        fed += chunk
        if fed % 4800 < chunk:
            rx3b.poll()
    rx3b.feed_audio(np.zeros(8000, np.float32))
    rx3b.poll()
    texts3b = []
    for fr in got3b:
        df = F.DataFrame.deserialize(fr.frame_bytes)
        if df:
            texts3b.append(df.payload_as_text())
    missing3b = [m for m in msgs if m not in texts3b]
    extra3b = [x for x in texts3b if x not in msgs]
    if verbose:
        print(f"strong crashes (+15 dB over frame, every frame): decoded "
              f"{len(texts3b)}/{num_frames}, pings {len(pings3b)}/1, "
              f"blanked {rx3b.blanker.blanked_runs} runs, "
              f"false={len(extra3b)}")
        for m in missing3b:
            print(f"  MISSING under crashes: {m}")
    phase3b = (not missing3b and not extra3b and len(pings3b) == 1
               and rx3b.blanker.blanked_runs >= num_frames)

    # --- phase 4: co-channel CW interferer (round-4 beyond-reference).
    # A persistent carrier at SIR 5 dB (vs mean in-frame power) rides the
    # WHOLE stream from sample 0 — without the adaptive narrowband exciser
    # (modem/excision.py) this decodes ~0 frames; with it, everything must
    # decode (the exciser engages during the 2-4 s noise lead) and the
    # noise floor must produce zero false decodes.
    tone_hz = 1234.5
    tone_p = sig_power / 10 ** (5.0 / 10.0)
    tphase = 2.0 * np.pi * tone_hz * np.arange(len(stream)) / 48000.0
    toned = stream + np.sqrt(2 * tone_p) * np.sin(tphase).astype(np.float32)
    rx4 = make_tx(WaveformMode.OFDM_COX)
    got4, pings4 = [], []
    rx4.on_frame = got4.append
    rx4.on_ping = pings4.append
    fed = 0
    for i in range(0, len(toned), chunk):
        rx4.feed_audio(toned[i:i + chunk])
        fed += chunk
        if fed % 4800 < chunk:
            rx4.poll()
    rx4.feed_audio(np.zeros(8000, np.float32))
    rx4.poll()
    texts4 = []
    for fr in got4:
        df = F.DataFrame.deserialize(fr.frame_bytes)
        if df:
            texts4.append(df.payload_as_text())
    missing4 = [m for m in msgs if m not in texts4]
    extra4 = [x for x in texts4 if x not in msgs]
    tones = rx4.exciser.active_tones
    if verbose:
        print(f"CW interferer @ {tone_hz} Hz SIR=5dB: decoded "
              f"{len(texts4)}/{num_frames}, pings {len(pings4)}/1, "
              f"false={len(extra4)}, notched={[round(t, 1) for t in tones]}")
        for m in missing4:
            print(f"  MISSING under tone: {m}")
    phase4 = (not missing4 and not extra4 and len(pings4) == 1
              and any(abs(t - tone_hz) < 15 for t in tones))

    # --- phase 5: COMPOUND impairments (round-4 beyond-reference): the
    # same stream with the CW interferer AND the strong mid-frame crashes
    # AND the gap crashes AND 85%-of-peak clipping, all at once.  The
    # blanker and exciser must compose: the blanker sees the un-notched
    # tone (its median absorbs the tone's power; gap crashes sink below
    # its threshold against the tone-lit floor — harmless, they never
    # cost a frame), the exciser's quiet-gated PSD must still lock the
    # tone through crash-lit blocks, and every frame must ride through
    # its own +15 dB crash.
    chaos = tough.copy()  # strong mid-frame + gap crashes from phase 3b
    chaos = chaos + np.sqrt(2 * tone_p) * np.sin(tphase).astype(np.float32)
    clip5 = 0.85 * float(np.abs(chaos).max())
    chaos = np.clip(chaos, -clip5, clip5)
    rx5 = make_tx(WaveformMode.OFDM_COX)
    got5, pings5 = [], []
    rx5.on_frame = got5.append
    rx5.on_ping = pings5.append
    fed = 0
    for i in range(0, len(chaos), chunk):
        rx5.feed_audio(chaos[i:i + chunk])
        fed += chunk
        if fed % 4800 < chunk:
            rx5.poll()
    rx5.feed_audio(np.zeros(8000, np.float32))
    rx5.poll()
    texts5 = []
    for fr in got5:
        df = F.DataFrame.deserialize(fr.frame_bytes)
        if df:
            texts5.append(df.payload_as_text())
    missing5 = [m for m in msgs if m not in texts5]
    extra5 = [x for x in texts5 if x not in msgs]
    tones5 = rx5.exciser.active_tones
    if verbose:
        print(f"COMPOUND (tone SIR5 + crashes + clip@85%): decoded "
              f"{len(texts5)}/{num_frames}, pings {len(pings5)}/1, "
              f"blanked {rx5.blanker.blanked_runs} runs, "
              f"notched={[round(t, 1) for t in tones5]}, "
              f"false={len(extra5)}")
        for m in missing5:
            print(f"  MISSING under compound: {m}")
    phase5 = (not missing5 and not extra5 and len(pings5) == 1
              and any(abs(t - tone_hz) < 15 for t in tones5))

    # --- phase 6: receiver AGC pumping (beyond-reference).  A real SSB
    # receiver's AGC multiplies the COMPOSITE signal+noise envelope by a
    # slowly varying gain (attack on a static crash or an adjacent strong
    # station, decay over hundreds of ms) — +-6 dB of pumping at ~0.3 Hz
    # is routine on crowded bands.  Amplitude wobble is invisible to the
    # differential modes and must be tracked by the Cox pilot/DD loops;
    # the blanker's +10 dB envelope gate and the exciser's running-min
    # floor must both ignore it (a false blank run inside a frame or a
    # self-notch would cost decodes).  No mitigation is expected to
    # engage: every frame + the ping must decode, zero false events.
    t6 = np.arange(len(stream), dtype=np.float32) / 48000.0
    gain_db = 6.0 * np.sin(2 * np.pi * 0.3 * t6, dtype=np.float32)
    pumped = stream * (10.0 ** (gain_db / 20.0)).astype(np.float32)
    rx6 = make_tx(WaveformMode.OFDM_COX)
    got6, pings6 = [], []
    rx6.on_frame = got6.append
    rx6.on_ping = pings6.append
    fed = 0
    for i in range(0, len(pumped), chunk):
        rx6.feed_audio(pumped[i:i + chunk])
        fed += chunk
        if fed % 4800 < chunk:
            rx6.poll()
    rx6.feed_audio(np.zeros(8000, np.float32))
    rx6.poll()
    texts6 = []
    for fr in got6:
        df = F.DataFrame.deserialize(fr.frame_bytes)
        if df:
            texts6.append(df.payload_as_text())
    missing6 = [m for m in msgs if m not in texts6]
    extra6 = [x for x in texts6 if x not in msgs]
    if verbose:
        print(f"AGC pumping (+-6 dB @ 0.3 Hz): decoded "
              f"{len(texts6)}/{num_frames}, pings {len(pings6)}/1, "
              f"blanked {rx6.blanker.blanked_runs} runs, "
              f"notched={[round(t, 1) for t in rx6.exciser.active_tones]}, "
              f"false={len(extra6)}")
        for m in missing6:
            print(f"  MISSING under AGC pumping: {m}")
    phase6 = (not missing6 and not extra6 and len(pings6) == 1
              and not rx6.exciser.active_tones
              and rx6.blanker.blanked_runs == 0)
    return phase1, phase2, phase3 and phase3b, phase4 and phase5, phase6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr", type=float, default=25.0)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--soak-minutes", type=float, default=10.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sro-ppm", type=float, default=0.0)
    ap.add_argument("--quick", action="store_true",
                    help="6 frames / 30 s / 1 min soak (test-suite scale)")
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.quick:
        args.frames, args.duration, args.soak_minutes = 6, 30.0, 1.0
    p1, p2, p3, p4, p5 = run(args.snr, args.frames, args.duration,
                             args.soak_minutes, sro_ppm=args.sro_ppm)
    print(f"frames+ping: {'PASS' if p1 else 'FAIL'}   "
          f"false-decode soak: {'PASS' if p2 else 'FAIL'}   "
          f"impulse torture: {'PASS' if p3 else 'FAIL'}   "
          f"CW interferer: {'PASS' if p4 else 'FAIL'}   "
          f"AGC pumping: {'PASS' if p5 else 'FAIL'}")
    return 0 if (p1 and p2 and p3 and p4 and p5) else 1


if __name__ == "__main__":
    sys.exit(main())
