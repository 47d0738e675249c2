#!/usr/bin/env python
"""Threaded two-station protocol simulator.

Reference: tools/threaded_simulator.cpp — two full stations with the audio
path and decoding on separate threads, exercising the same concurrency the
GUI runs (audio callback thread vs decode threads).  Here:

  * each station = ProtocolEngine + AudioEngine over the native lock-free
    SPSC ring;
  * one "air" thread pumps both audio engines (A's speaker -> channel ->
    B's mic and vice versa, in 1024-sample buffers);
  * one decode thread per station drives its modem's poll cadence;
  * the main thread drives connect / message / disconnect with timeouts.

Usage: python tools/threaded_simulator.py [--cpu] [--snr DB]
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--snr", type=float, default=15.0)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp

    from projectultra.modem.audio import AudioEngine, LoopbackBackend
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    def channel(audio: np.ndarray) -> np.ndarray:
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        a = W.add_noise_active(jax.random.PRNGKey(len(audio) & 0xFFFF), a,
                               args.snr)
        return np.asarray(a)[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(args.snr)

    # A's speaker is B's mic and vice versa.
    a_air = AudioEngine(LoopbackBackend(channel=channel))
    b_air = AudioEngine(LoopbackBackend(channel=channel))
    a.on_tx_audio = a_air.play
    b.on_tx_audio = b_air.play
    a_air.set_rx_callback(lambda chunk: b.modem.feed_audio(chunk))
    b_air.set_rx_callback(lambda chunk: a.modem.feed_audio(chunk))

    stop = threading.Event()
    got_b, got_a = [], []
    b.connection.on_message_received = got_b.append
    a.connection.on_message_received = got_a.append

    def air_loop():
        while not stop.is_set():
            a_air.pump()
            b_air.pump()
            time.sleep(0.005)

    def decode_loop(engine):
        while not stop.is_set():
            engine.modem.poll()
            engine.tick(20)
            time.sleep(0.02)

    threads = [threading.Thread(target=air_loop, daemon=True),
               threading.Thread(target=decode_loop, args=(a,), daemon=True),
               threading.Thread(target=decode_loop, args=(b,), daemon=True)]
    for t in threads:
        t.start()

    def wait_for(cond, what, timeout):
        t0 = time.time()
        while time.time() - t0 < timeout:
            time.sleep(0.05)
            if cond():
                print(f"  [ok] {what} ({time.time() - t0:.1f}s)")
                return True
        print(f"  [TIMEOUT] {what}")
        return False

    ok = True
    print(f"threaded two-station simulator — SNR {args.snr:.0f} dB")
    print("[1] A connects to B")
    a.connect("VE3ABC")
    ok &= wait_for(lambda: a.connection.is_connected
                   and b.connection.is_connected, "connected",
                   args.timeout / 2)
    if ok:
        print("[2] messages both ways")
        a.send_message("hello from A")
        ok &= wait_for(lambda: "hello from A" in got_b, "A->B message",
                       args.timeout / 4)
        b.send_message("hello from B")
        ok &= wait_for(lambda: "hello from B" in got_a, "B->A message",
                       args.timeout / 4)
    if ok:
        print("[3] disconnect")
        a.disconnect()
        ok &= wait_for(lambda: not b.connection.is_connected, "B saw disconnect",
                       args.timeout / 4)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    print(f"RESULT: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
