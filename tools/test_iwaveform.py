#!/usr/bin/env python
"""Flag-for-flag equivalent of the reference's PRIMARY harness
(tools/test_iwaveform.cpp): N frames of one waveform through one receiver
at a given SNR/CFO/channel, reporting decode rate.

Two disciplines:
  default  — the batched device-program sweep (parallel/sweep.run_point);
  --stream — N frames as ONE continuous stream through ONE ModemEngine in
             960-sample chunks (the reference's own anti-cheat rules,
             test_iwaveform.cpp:340-600).

Usage mirrors the reference:
  python tools/test_iwaveform.py --snr 15 -w mc_dpsk --channel awgn \
         --cfo 30 --rate r1_4 --frames 5 [--stream] [--cpu] [--seed N]
Waveforms: mc_dpsk, ofdm_chirp, dpsk (single-carrier; --preset selects the
speed preset, default robust).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr", type=float, default=15.0)
    ap.add_argument("--cfo", type=float, default=0.0)
    ap.add_argument("--channel", default="awgn",
                    choices=["awgn", "good", "moderate", "poor", "flutter"])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("-w", "--waveform", default="mc_dpsk",
                    choices=["mc_dpsk", "ofdm_chirp", "dpsk"])
    ap.add_argument("--rate", default="r1_2",
                    choices=["r1_4", "r1_3", "r1_2", "r2_3", "r3_4", "r5_6"])
    ap.add_argument("--preset", default="robust",
                    help="single-carrier DPSK preset (psk/dpsk.py factories)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--stream", action="store_true",
                    help="single-stream discipline through one ModemEngine")
    ap.add_argument("--chunk", type=int, default=960)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from projectultra.config import CodeRate
    from projectultra.parallel.sweep import (SweepPoint, run_point,
                                                 run_point_stream)

    wf = {"mc_dpsk": "MC_DPSK", "ofdm_chirp": "OFDM_CHIRP",
          "dpsk": "DPSK"}[args.waveform]
    rate = CodeRate[args.rate.upper()]
    # MC-DPSK always rides R1/4 per protocol (test_iwaveform.cpp usage).
    if wf == "MC_DPSK":
        rate = CodeRate.R1_4
    point = SweepPoint(wf, args.snr, args.cfo, args.channel, rate=rate,
                       frames=args.frames,
                       preset=args.preset if wf == "DPSK" else "")

    res = (run_point_stream(point, seed=args.seed, chunk=args.chunk)
           if args.stream else run_point(point, seed=args.seed))
    print(f"{wf} {args.channel} SNR={args.snr:+.1f} CFO={args.cfo:+.0f} "
          f"rate={rate.name} frames={args.frames}"
          f"{' [stream]' if args.stream else ''}")
    print(f"  decode {res.decode_rate:.0%}  detect {res.detected_rate:.0%}"
          + ("" if args.stream else f"  BER {res.ber:.4f}"))
    return 0 if res.decode_rate > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
