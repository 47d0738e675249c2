#!/usr/bin/env python
"""Session-level (ARQ-inclusive) over-the-air throughput.

The frame-level table (tools/test_throughput.py) measures isolated frames;
this tool measures what a USER gets: a full two-ProtocolEngine session —
chirp ping, CONNECT negotiation, calibrated adaptive climb, then a file
transfer of incompressible bytes — with every protocol cost included
(ACKs, mode changes, ARQ retries, chunk headers).  Reported per row:

  steady kbps  = file_bits / audio seconds exchanged DURING the transfer
                 (both directions: data + ACK audio) — the sustained rate.
  session kbps = file_bits / ALL audio from the first ping — includes the
                 connect + adaptive-climb overhead.

Reference comparison: its headline link table peaks at 7.2 kbps
(1024-FFT 32QAM R3/4, README.md:57) and its ARQ/file machinery runs the
same frame formats, so `steady` is directly comparable.

Usage: python tools/test_session_throughput.py [--rows nvis,512] [--bytes N]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_session(profile, true_snr, n_bytes, warm_msgs=16, chunk=4000,
                sro_ppm=0.0):
    """warm_msgs >= 16: the flat-evidence gate needs STABLE_WINDOW (6)
    readings plus FLAT_FRAMES (3) before the high-order ladder opens, and
    the upgrade debounce then wants 4 consecutive recommendations.

    chunk=4000 (vs the reference's 250) + the pipelined chunker: the
    session bottleneck at high-order modes is per-frame overhead — every
    DATA frame pays a full Cox preamble and earns a full ACK frame of
    return audio — so 16x chunks means ~16x fewer overhead frames.
    Round-4 history: 4000 used to COLLAPSE at QAM256 R5/6 — the partial
    final OFDM symbol's 52/59 TX-dead carriers poisoned the rank-1 DD fit
    and deterministically corrupted the last codeword at ANY SNR
    (demodulator._live_carrier_mask); with the mask + CRC-aided recovery
    (fec/crc_recover.py) 4000-byte chunks hold 20/20 at 34 dB and the
    NVIS row reads 12.3 kbps steady (was 10.28 at 2000)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from projectultra.config import nvis_mode
    from projectultra.modem.engine import ModemEngine
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(int(true_snr * 17) + len(profile))
    counter = [0]
    audio_samples = [0]

    # TX/RX sample-clock skew (tools/test_sro.py): station A's DAC/ADC
    # run sro_ppm fast relative to B's, so A->B audio resamples by +ppm
    # and B->A by -ppm — both radios see the skew, like real hardware.
    if sro_ppm:
        import importlib.util
        _spec = importlib.util.spec_from_file_location(
            "sro_tool", os.path.join(os.path.dirname(__file__),
                                     "test_sro.py"))
        _sro = importlib.util.module_from_spec(_spec)
        _spec.loader.exec_module(_sro)
        _apply_sro = _sro.apply_sro
    else:
        _apply_sro = None

    def channel(audio, ppm=0.0):
        counter[0] += 1
        audio_samples[0] += len(audio)
        if _apply_sro is not None and ppm:
            audio = _apply_sro(audio, ppm)
        a = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        k = jax.random.fold_in(key, counter[0])
        a = W.add_noise_active(k, a, true_snr)
        return np.asarray(a)[0]

    mk = (lambda: ModemEngine(config=nvis_mode())) if profile == "nvis" \
        else (lambda: ModemEngine())
    a, b = ProtocolEngine(mk()), ProtocolEngine(mk())
    for e in (a, b):
        e.connection.config.calibrated_snr = True
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(true_snr)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio, sro_ppm))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio, -sro_ppm))
    got_b = []
    b.connection.on_message_received = got_b.append

    if not a.connect("VE3ABC"):
        return None

    # Adaptive climb: short messages BOTH ways — the initiator's
    # controller reads SNR from frames it RECEIVES, so b must talk too
    # (upgrade debounce = 4 consecutive recommendations + flat gate).
    got_a = []
    a.connection.on_message_received = got_a.append
    ia = ib = 0
    for _ in range(200):
        if ia < warm_msgs and a.send_message(f"w{ia:02d}"):
            ia += 1
        if ib < warm_msgs and b.send_message(f"v{ib:02d}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if (ia >= warm_msgs and ib >= warm_msgs
                and len(got_b) >= warm_msgs and len(got_a) >= warm_msgs):
            break
    climb_samples = audio_samples[0]

    # Timed region: one file of incompressible bytes a -> b.
    a.connection.file_transfer.chunk_size = chunk
    # Receiver-side SACK coalescing (wire-identical, see arq.py): one
    # SACK per 3 in-order chunks instead of per frame — every SACK costs
    # a full preamble + codeword of return audio.
    b.connection.arq.sack_every = 3
    rng = np.random.default_rng(7)
    tmpdir = tempfile.mkdtemp()
    src = os.path.join(tmpdir, "payload.bin")
    with open(src, "wb") as f:
        f.write(rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes())
    received = []
    rxdir = os.path.join(tmpdir, "rx")
    os.makedirs(rxdir, exist_ok=True)
    # Separate receive dir: same-basename delivery into tmpdir would
    # overwrite src and make the byte comparison vacuous.
    b.connection.file_transfer.receive_dir = rxdir
    b.connection.file_transfer.on_received = \
        lambda path, ok: received.append((path, ok))
    if not a.connection.send_file(src):
        return None
    for _ in range(600):
        if received:
            break
        a.tick(5000)
        b.tick(5000)
    if not received or not received[0][1]:
        return None
    with open(received[0][0], "rb") as f:
        ok = f.read() == open(src, "rb").read()
    if not ok:
        return None
    transfer_samples = audio_samples[0] - climb_samples
    bits = n_bytes * 8
    steady = bits / (transfer_samples / 48000.0) / 1000.0
    session = bits / (audio_samples[0] / 48000.0) / 1000.0
    mode = f"{a.modem.data_modulation.name}/{a.modem.data_code_rate.name}"
    return mode, steady, session


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="512_26,512_32,nvis_34",
                    help="comma list of profile_snr rows")
    ap.add_argument("--bytes", type=int, default=6000)
    ap.add_argument("--chunk", type=int, default=4000)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (default: CPU)")
    ap.add_argument("--sro-ppm", type=float, default=0.0,
                    help="TX/RX sample-clock skew in ppm (A fast, B slow)")
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.gpu:
        backend.require_gpu()
    else:
        jax.config.update("jax_platforms", "cpu")

    print("=== session throughput (ARQ-inclusive over-the-air) ===")
    print(f"  file: {args.bytes} incompressible bytes; "
          f"reference headline: 7.2 kbps frame-level")
    all_ok = True
    for row in args.rows.split(","):
        profile, snr = row.rsplit("_", 1)
        r = run_session(profile, float(snr), args.bytes, chunk=args.chunk,
                        sro_ppm=args.sro_ppm)
        if r is None:
            print(f"  {row:10s}: FAIL")
            all_ok = False
            continue
        mode, steady, session = r
        print(f"  {row:10s}: mode={mode:13s} steady={steady:6.2f} kbps "
              f"session={session:6.2f} kbps", flush=True)
    print("RESULT:", "PASS" if all_ok else "FAIL")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
