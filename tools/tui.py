#!/usr/bin/env python
"""Terminal UI: the reference GUI's panels rendered as ANSI text.

Reference: src/gui/ (ImGui App: waterfall, constellation, status bar,
message console, `-sim` virtual remote station).  This container has no
display, so the same panels render to the terminal from the identical data
products (`utils/observability.py`):

  * waterfall — 2048-point FFT, 0..3 kHz band, ASCII intensity ramp;
  * status — connection FSM state, negotiated waveform, data mode, SNR,
    frames sent/received;
  * console — received/sent messages.

`--sim` runs the GUI's virtual-remote-station mode: a second full station
behind a noisy channel, scripted connect -> chat -> disconnect, dashboard
snapshots printed after each step (CI-friendly; also the smoke test).

Usage: python tools/tui.py --sim [--cpu] [--snr DB]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

RAMP = " .:-=+*#%@"


def render_waterfall(audio, width=64, lines=12):
    import numpy as np
    from projectultra.utils.observability import waterfall
    if audio is None or len(audio) < 4096:
        return ["(no audio yet)"]
    db, freqs = waterfall(audio)
    keep = freqs <= 3000.0
    db = db[-lines:, keep]
    lo, hi = db.min(), max(db.max(), db.min() + 1e-6)
    norm = (db - lo) / (hi - lo)
    cols = np.linspace(0, norm.shape[1] - 1, width).astype(int)
    out = []
    for row in norm[:, cols]:
        out.append("".join(RAMP[int(v * (len(RAMP) - 1))] for v in row))
    return out


def render_constellation(points, size=17):
    import numpy as np
    if points is None or len(points) == 0:
        return []
    from projectultra.utils.observability import constellation
    iq = constellation(points)
    lim = max(1e-6, float(np.abs(iq).max())) * 1.1
    grid = [[" "] * (2 * size + 1) for _ in range(size + 1)]
    for re, im in iq:
        x = int((re / lim + 1) * size)
        y = int((1 - im / lim) * size / 2)
        if 0 <= y <= size and 0 <= x <= 2 * size:
            grid[y][x] = "o"
    mid = size // 2
    for y in range(size + 1):
        if grid[y][size] == " ":
            grid[y][size] = "|" if y != mid else "+"
    return ["".join(row) for row in grid]


def render_dashboard(title, station, last_audio, messages):
    c = station.connection
    m = station.modem
    lines = [f"== {title} " + "=" * max(0, 60 - len(title)),
             f" state: {c.state.name:<13} remote: {c.remote_call or '-':<10}"
             f" waveform: {c.negotiated_mode.name if c.is_connected else '-'}",
             f" mode: {m.data_modulation.name} "
             f"{m.data_code_rate.name[1:].replace('_', '/')}"
             f"   snr: {m.stats.current_snr_db:5.1f} dB"
             f"   tx/rx frames: {m.stats.frames_sent}/{m.stats.frames_received}"
             f"   pings: {m.pings_received}",
             " waterfall (0-3 kHz):"]
    lines += ["   " + w for w in render_waterfall(last_audio)]
    cpts = render_constellation(m.last_constellation)
    if cpts:
        lines.append(" constellation (equalized):")
        lines += ["   " + c for c in cpts]
    lines.append(" console:")
    lines += [f"   {t}" for t in messages[-4:]] or ["   (empty)"]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim", action="store_true",
                    help="virtual remote station (GUI -sim mode)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--snr", type=float, default=15.0)
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not args.sim:
        print("interactive radio mode needs audio hardware; run with --sim")
        return 2

    import numpy as np
    import jax.numpy as jnp
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(args.snr)
    a.modem.collect_constellation = True
    b.modem.collect_constellation = True

    last_rx = {"a": None, "b": None}
    console = []

    def channel(audio):
        x = jnp.asarray(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :])
        x = W.add_noise_active(jax.random.PRNGKey(len(audio) & 0xFFFF), x,
                               args.snr)
        return np.asarray(x)[0]

    def a_to_b(audio):
        rx = channel(audio)
        last_rx["b"] = rx
        b.feed_audio(rx)

    def b_to_a(audio):
        rx = channel(audio)
        last_rx["a"] = rx
        a.feed_audio(rx)

    a.on_tx_audio = a_to_b
    b.on_tx_audio = b_to_a
    a.connection.on_message_received = \
        lambda t: console.append(f"VE3ABC> {t}")
    b_console = []
    b.connection.on_message_received = \
        lambda t: b_console.append(f"W1AW> {t}")

    def show(step):
        print(f"\n--- {step} " + "-" * max(0, 50 - len(step)))
        print(render_dashboard("W1AW (local)", a, last_rx["a"], console))

    ok = True
    show("startup")
    ok &= a.connect("VE3ABC")
    ok &= a.connection.is_connected and b.connection.is_connected
    show("connected")
    console.append("me> hello remote")
    ok &= a.send_message("hello remote")
    ok &= b.send_message("hello local") if ok else False
    show("chat")
    a.disconnect()
    show("disconnected")
    good = ok and "VE3ABC> hello local" in console \
        and "W1AW> hello remote" in b_console \
        and not b.connection.is_connected
    print(f"\nRESULT: {'PASS' if good else 'FAIL'}")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
