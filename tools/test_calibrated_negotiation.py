#!/usr/bin/env python
"""Auto-negotiation envelope sweep (VERDICT r2 #2 done-criterion).

For true wideband SNRs across 5-20 dB on AWGN and moderate-fading Watterson
channels, run a full two-ProtocolEngine over-the-air session with
calibrated_snr on: connect (auto-negotiate waveform + data mode from the
measured SNR), exchange messages both ways, and report the negotiated mode
plus delivery success.  PASS = every point connects and delivers all
messages — i.e. the auto-picked mode stays inside the channel envelope.
Optionally --parity runs the same sweep on the reference-parity inflated
scale for comparison (expected to fail below ~12 dB true).

Usage: python tools/test_calibrated_negotiation.py [--messages N] [--parity]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_session(true_snr, chan, n_msgs, calibrated):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(int(true_snr * 13) + (7 if chan == "fade" else 0))
    counter = [0]

    def channel(audio):
        counter[0] += 1
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        k = jax.random.fold_in(key, counter[0])
        if chan == "awgn":
            a = W.add_noise_active(k, a, true_snr)
        else:
            a = W.watterson(k, a, W.PRESETS["moderate"](true_snr))
        return np.asarray(a)[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    for e in (a, b):
        e.connection.config.calibrated_snr = calibrated
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(true_snr)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append

    if not a.connect("VE3ABC"):
        return None
    mode = b.connection.negotiated_mode.name
    dmode = f"{b.connection.data_modulation.name}/" \
            f"{b.connection.data_code_rate.name}"

    ia = ib = 0
    for _ in range(1500):
        if ia < n_msgs and a.send_message(f"a{ia:02d}"):
            ia += 1
        if ib < n_msgs and b.send_message(f"b{ib:02d}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if (ia >= n_msgs and ib >= n_msgs
                and len(got_a) >= n_msgs and len(got_b) >= n_msgs):
            break
    ok = (got_b == [f"a{i:02d}" for i in range(n_msgs)]
          and got_a == [f"b{i:02d}" for i in range(n_msgs)])
    final = f"{a.modem.data_modulation.name}/" \
            f"{a.modem.data_code_rate.name}"
    return mode, dmode, ok, final


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--messages", type=int, default=6)
    ap.add_argument("--parity", action="store_true",
                    help="sweep the reference-parity inflated scale instead")
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    jax.config.update("jax_platforms", "cpu")

    calibrated = not args.parity
    print(f"=== auto-negotiation envelope sweep "
          f"({'calibrated' if calibrated else 'reference-parity'} scale) ===")
    all_ok = True
    # (chan, snr, min final-mode throughput rank): the 26/32 dB AWGN rows
    # additionally require mid-session adaptation to CLIMB into the
    # flat-gated high-order ladder (HIGH_TABLE) — QAM64 R2/3 (rank 4) and
    # QAM256 R2/3 (rank 5.33) — proving the beyond-reference flat-channel
    # throughput path end to end.
    grid = [("awgn", s, None) for s in (5.0, 8.0, 12.0, 16.0, 20.0)]
    grid += [("fade", s, None) for s in (5.0, 8.0, 12.0, 16.0, 20.0)]
    if calibrated:
        grid += [("awgn", 26.0, 3.9), ("awgn", 32.0, 5.2)]
    from projectultra.config import (Modulation, CodeRate,
                                         bits_per_symbol, code_rate_value)

    def rank(dmode: str) -> float:
        m, r = dmode.split("/")
        return bits_per_symbol(Modulation[m]) * code_rate_value(CodeRate[r])

    for chan, snr, min_rank in grid:
        # Climb rows need >= 14 data frames each way: control-frame
        # readings are excluded from calibrated negotiation, so the flat
        # gate (6-reading window + 3 flat frames) plus the 4-pending
        # upgrade debounce takes ~13 DATA readings.
        n = args.messages if min_rank is None else max(args.messages, 14)
        r = run_session(snr, chan, n, calibrated)
        if r is None:
            print(f"  {chan:5s} {snr:5.1f} dB: CONNECT FAILED")
            all_ok = False
            continue
        mode, dmode, ok, final = r
        climbed = min_rank is None or rank(final) >= min_rank
        print(f"  {chan:5s} {snr:5.1f} dB: {mode:9s} init={dmode:13s} "
              f"final={final:13s} "
              f"{'PASS' if ok and climbed else 'FAIL'}", flush=True)
        all_ok = all_ok and ok and climbed
    print("RESULT:", "PASS" if all_ok else "FAIL")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
