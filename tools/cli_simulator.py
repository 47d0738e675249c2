#!/usr/bin/env python
"""Two-station protocol simulator over a simulated HF channel.

Reference: tools/cli_simulator.cpp — two complete stations (ModemEngine +
ProtocolEngine each) in one process, connected through the Watterson channel.
Runs a scripted session: PING/PONG probe, CONNECT handshake with mode
negotiation, bidirectional messages, optional file transfer, DISCONNECT.

Usage:
  python tools/cli_simulator.py [--snr 15] [--channel awgn|good|moderate|poor]
                                [--cfo 0] [--message "..."] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr", type=float, default=15.0)
    ap.add_argument("--channel", default="awgn",
                    choices=["clean", "awgn", "good", "moderate", "poor"])
    ap.add_argument("--cfo", type=float, default=0.0)
    ap.add_argument("--message", default="Hello from the modem!")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax
    import jax.numpy as jnp
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(args.seed)
    counter = [0]

    def channel(audio: np.ndarray) -> np.ndarray:
        nonlocal key
        counter[0] += 1
        # 2000-sample lead models the receiver hearing the band before the
        # transmission (a CFO-shifted up-chirp peak can land up to
        # cfo*10 samples BEFORE the chirp itself).
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        if args.cfo:
            a = W.apply_cfo_hilbert(a, jnp.asarray([args.cfo]))
        if args.channel == "awgn":
            a = W.add_noise_active(jax.random.fold_in(key, counter[0]),
                                   a, args.snr)
        elif args.channel != "clean":
            a = W.watterson(jax.random.fold_in(key, counter[0]), a,
                            W.PRESETS[args.channel](args.snr))
        return np.asarray(a)[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(args.snr)

    a.on_tx_audio = lambda audio: (
        print(f"  [A->B] {len(audio)} samples ({len(audio) / 48000:.2f}s)"),
        b.feed_audio(channel(audio)))
    b.on_tx_audio = lambda audio: (
        print(f"  [B->A] {len(audio)} samples ({len(audio) / 48000:.2f}s)"),
        a.feed_audio(channel(audio)))

    b.connection.on_message_received = \
        lambda t: print(f'  [B] received: "{t}"')
    a.connection.on_message_received = \
        lambda t: print(f'  [A] received: "{t}"')
    a.connection.on_connected = lambda: print("  [A] CONNECTED")
    b.connection.on_connected = lambda: print("  [B] CONNECTED")
    a.connection.on_disconnected = lambda r: print(f"  [A] disconnected: {r}")
    b.connection.on_disconnected = lambda r: print(f"  [B] disconnected: {r}")

    print(f"=== channel: {args.channel} SNR={args.snr} dB CFO={args.cfo} Hz ===")
    print("[1] A connects to B (PING -> PONG -> CONNECT -> ACK)")
    a.connect("VE3ABC")
    if not (a.connection.is_connected and b.connection.is_connected):
        print("CONNECT FAILED"); return 1
    print(f"    negotiated waveform: {b.connection.negotiated_mode.name}, "
          f"data mode: {a.connection.data_modulation.name} "
          f"{a.connection.data_code_rate.name}")

    print("[2] A -> B message")
    a.send_message(args.message)
    print("[3] B -> A message")
    b.send_message("QSL, copy 100%. 73!")

    print("[4] A disconnects")
    a.disconnect()
    a.tick(60000)

    sa, sb = a.modem.stats, b.modem.stats
    print("\n=== stats ===")
    print(f"  A: sent {sa.frames_sent} frames / {sa.bytes_sent} B, "
          f"received {sa.frames_received}")
    print(f"  B: sent {sb.frames_sent} frames / {sb.bytes_sent} B, "
          f"received {sb.frames_received}")
    print(f"  ARQ A: {a.connection.arq.stats}")
    ok = sa.frames_received > 0 and sb.frames_received > 0
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
