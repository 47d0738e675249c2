#!/usr/bin/env python
"""Smoke run of the modem's main path on one GPU.

    python chip_smoke.py           # one GPU: the phases below, in order
    python chip_smoke.py --multi   # four GPUs: sharded sweeps vs one GPU

Phases (one process for the card; any failed gate exits non-zero):

  device     JAX's first device is a GPU; nvidia-smi's name and power limit.
  pipeline   the headline cell (OFDM_CHIRP DQPSK R1/2, AWGN 17 dB, 16384
             frames) as bench.py compiles it; then 64 frames' equalized
             symbols and pre-LDPC LLRs on the GPU against the CPU backend,
             and the LDPC decoder fed identical LLRs on both, lane for lane.
  chirp_acq  MC-DPSK level 10 with dual-chirp acquisition, R1/4, 5 dB, 256;
             then the demod's LLRs on the GPU against the CPU backend, fed
             the same acquired spans.
  cox_acq    OFDM_COX DQPSK R1/2 with Schmidl-Cox acquisition, 17 dB, 512.
  modem      `ultra ptx` -> `ultra prx` for three waveforms, the reference
             binary's own transmissions, and one two-station session.

Each phase prints one line: its wall time, the part of it XLA spent
compiling (as JAX reports it; programs found in the persistent compile cache
are not compiled again), and its gates.
These are smoke timings of single calls, not benchmark numbers.  The last
line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "data", "golden")

PIPELINE_BATCH = 16384
COMPARE_FRAMES = 64
# A second LLR set for the lane-for-lane LDPC check, at the waterfall edge:
# about half the lanes converge, after ~24 iterations on average, and the
# rest run to the limit (at 17 dB every lane converges at iteration 0,
# which compares little).
LDPC_HARD_SNR_DB = 0.0
CHIRP_BATCH = 256
COX_BATCH = 512
MIN_DECODE_RATE = 0.99  # bench.py's gate
# GPU against CPU.  The card runs f32 matmuls that do not ask for HIGHEST
# precision in TF32: inputs keep 10 mantissa bits, a relative rounding of
# 2^-11 ~ 5e-4 per operand; the CPU computes them in full f32.
#
# Headline equalized symbols, before the demapper (the LLRs made from them
# sit at the +-10 clip almost everywhere, so those alone compare little).
# Every contraction on that path asks for HIGHEST, so the backends differ
# only in the order of f32 sums (~600-term DFT rows, the LTS average) and in
# their trig and FFT code.  f32 against an f64 run of the same code, 64
# frames on the CPU: worst error 1.8e-6 of the symbols' RMS at 17 dB and
# 1.0e-5 at 0 dB, i.e. 30 and 170 times f32's rounding (the DFT sums cancel).
# Two f32 backends differ by at most about twice that.  The gate, 1e-3 of
# the RMS, leaves a fiftyfold margin, and a TF32 contraction (rounding
# 2^-11, amplified alike) would miss it by more than tenfold.
EQ_RTOL = 1e-3
# Pre-LDPC LLRs of both cells, elementwise: at most LLR_ATOL + LLR_RTOL |LLR|
# (the absolute term covers LLRs near zero).  The MC-DPSK demod's carrier
# correlations (psk/mc_dpsk.correlate_symbols) run in TF32 on the card; a
# few stages after them (normalisation, differential product, angle) keep
# the error of order 1e-3 relative, and 1e-2 leaves a tenfold margin.  At
# 5 dB those LLRs sit below the clip (median ~1.4), so this compares values.
LLR_RTOL = 1e-2
LLR_ATOL = 1e-2
MULTI_DEVICES = 4
MULTI_ACQ_FRAMES = 256
MULTI_PIPELINE_FRAMES = 16384
# Noise on the sharded pipeline's input (the frames' RMS is ~0.3), chosen
# so some frames fail: the psum'd totals are then non-zero and their
# equality says something.
MULTI_NOISE_STD = 0.25


class SmokeFailure(RuntimeError):
    pass


# JAX reports the duration of every XLA compilation under this event.
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class Phase:
    """Times one phase, sums its XLA compile time, collects its gates."""

    def __init__(self, name: str):
        import jax
        self.name = name
        self.t0 = time.perf_counter()
        self.wall_s = None
        self.compile_s = 0.0
        self.programs = 0
        self.gates: list[tuple[str, object, bool]] = []
        self.notes: list[str] = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_):
        if event == COMPILE_EVENT:
            self.compile_s += duration
            self.programs += 1

    def stop(self):
        """Freeze the wall time and stop counting compilations."""
        if self.wall_s is None:
            import jax
            self.wall_s = time.perf_counter() - self.t0
            jax.monitoring.unregister_event_duration_listener(self._on_event)

    def gate(self, name: str, value, ok=None):
        """Record a gate; `ok` defaults to the truth of `value`."""
        self.gates.append((name, value, bool(value if ok is None else ok)))

    def note(self, text: str):
        self.notes.append(text)

    @property
    def ok(self) -> bool:
        return all(ok for _, _, ok in self.gates)

    def line(self) -> str:
        self.stop()
        gates = " ".join(f"{n}={v}{'' if ok else '[FAIL]'}"
                         for n, v, ok in self.gates)
        return (f"phase={self.name} ok={self.ok} "
                f"smoke_wall_s={self.wall_s:.3f} compile_s={self.compile_s:.3f} "
                f"programs_compiled={self.programs} | {gates}")


def _bits_gates(ph: Phase, out, ok, info):
    """bench.py's gates: decode rate, and every decoded frame bit-exact."""
    out, ok = np.asarray(out), np.asarray(ok)
    info = np.asarray(info, np.uint8)
    rate = float(ok.mean())
    ph.gate("decode_rate", rate, rate >= MIN_DECODE_RATE)
    ph.gate("bits_equal", bool((out[ok] == info[ok]).all()))


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def _backend_gate(ph: Phase, label, dev_val, cpu_val, bound):
    """Gate `label` on |GPU - CPU| <= bound everywhere; note the worst
    error against the values' RMS."""
    err = np.abs(dev_val - cpu_val)
    ph.gate(f"{label}_max_abs_err", float(err.max()),
            bool((err <= bound).all()))
    ph.note(f"{label}: max abs err {float(err.max()):.3g}, RMS "
            f"{_rms(cpu_val):.3g}, max err / RMS "
            f"{float(err.max()) / _rms(cpu_val):.3g}")


def _on_both(ph: Phase, label, fn, args, dev, cpu) -> dict:
    """`fn(*args)` with the same inputs on the GPU and on the CPU backend;
    gates that each ran where it was put.  Returns numpy results by name."""
    import jax
    res = {}
    for name, d in (("dev", dev), ("cpu", cpu)):
        out = fn(*jax.device_put(args, d))
        leaves = jax.tree_util.tree_leaves(out)
        ph.gate(f"{label}_ran_on_{name}",
                all(x.devices() == {d} for x in leaves))
        res[name] = jax.tree_util.tree_map(np.asarray, out)
    return res


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + " ".join(
        f"{f}={getattr(m, f, 'n/a')}" for f in fields)


def check_device(devices) -> dict:
    """JAX's device record; raises unless the devices are GPUs."""
    from projectultra.utils import backend
    backend.require_gpu(devices)
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def phase_pipeline(dev, cpu, batch=PIPELINE_BATCH,
                   compare_frames=COMPARE_FRAMES) -> Phase:
    """The headline cell on `dev`, then its LLRs and LDPC against `cpu`."""
    import jax
    import bench
    from projectultra.fec import ldpc
    from projectultra.ofdm import demodulator as demod_mod
    from projectultra.ofdm import pipeline as P
    from projectultra.ops import demap
    from projectultra.sim import watterson as W

    ph = Phase("pipeline")
    code = ldpc.get_code(bench.RATE)
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (batch, code.k)).astype(np.float32)
    info_d = jax.device_put(info, dev)
    key = jax.device_put(jax.random.PRNGKey(0), dev)
    step = bench._step.lower(info_d, key).compile()
    out, ok = step(info_d, key)
    _bits_gates(ph, out, ok, info)
    ph.note(_memory_line(step))

    # The same noisy input, made once, through the same jitted functions on
    # both backends: at the cell's SNR, and at the waterfall edge, where the
    # decoder iterates.
    tx = P.tx_frame(bench.CFG, bench.MOD, bench.RATE,
                    jax.device_put(info[:compare_frames], dev))
    equalize = jax.jit(functools.partial(
        demod_mod.equalized_presynced, bench.CFG, bench.MOD,
        training_symbols=P.TRAINING_SYMBOLS,
        num_data_symbols=P.num_data_symbols(bench.CFG, bench.MOD)))
    rx_llrs = functools.partial(P.rx_llrs, bench.CFG, bench.MOD)
    for key_seed, snr in ((1, bench.SNR_DB), (2, LDPC_HARD_SNR_DB)):
        noisy = np.asarray(W.add_noise_active(jax.random.PRNGKey(key_seed),
                                              tx, snr))
        eq = _on_both(ph, f"eq{snr:g}dB", equalize, (noisy,), dev, cpu)
        _backend_gate(ph, f"eq{snr:g}dB", eq["dev"][0], eq["cpu"][0],
                      EQ_RTOL * _rms(eq["cpu"][0]))
        llr = _on_both(ph, f"llr{snr:g}dB", rx_llrs, (noisy,), dev, cpu)
        mag = np.abs(llr["cpu"])
        _backend_gate(ph, f"llr{snr:g}dB", llr["dev"], llr["cpu"],
                      LLR_ATOL + LLR_RTOL * mag)
        ph.note(f"llr{snr:g}dB: share at the clip "
                f"{float((mag >= demap.MAX_LLR).mean()):.4g}")
        _ldpc_lanes(ph, f"ldpc{snr:g}dB", code, llr["dev"], dev, cpu)
    return ph


def _ldpc_lanes(ph: Phase, label, code, llrs, dev, cpu):
    """The decoder fed identical LLRs on both backends, f32 messages:
    bits, ok and iteration counts must be equal lane for lane."""
    import jax
    import jax.numpy as jnp
    from projectultra.ops import ldpc as ldpc_ops
    res = {}
    for name, d in (("dev", dev), ("cpu", cpu)):
        bits, ok, iters = ldpc_ops.decode(code, jax.device_put(llrs, d),
                                          msg_dtype=jnp.float32)
        res[name] = (np.asarray(bits), np.asarray(ok), np.asarray(iters))
    same = all(np.array_equal(a, b) for a, b in zip(res["dev"], res["cpu"]))
    ph.gate(f"{label}_lanes_equal", same)
    ok, iters = res["cpu"][1], res["cpu"][2]
    ph.note(f"{label}: ok {int(ok.sum())}/{len(iters)}, "
            f"iters mean {float(iters.mean()):.2f} max {int(iters.max())}")


def _acq_phase(name, cell, key_seed, dev) -> tuple[Phase, object]:
    """The cell's gates on `dev`; returns the phase and the noisy input."""
    import jax
    ph = Phase(name)
    rx = jax.device_put(cell.add_noise(cell.tx, jax.random.PRNGKey(key_seed)),
                        dev)
    compiled = cell.step.lower(rx).compile()
    out, ok = compiled(rx)
    _bits_gates(ph, out, ok, cell.info)
    ph.note(_memory_line(compiled))
    return ph, rx


def phase_chirp_acq(dev, cpu, batch=CHIRP_BATCH) -> Phase:
    """The chirp cell on `dev`; then its demod fed the same acquired spans
    on `dev` and on `cpu`, LLRs compared elementwise."""
    import bench
    cell = bench.build_acq(batch)
    ph, rx = _acq_phase("chirp_acq", cell, 3, dev)
    demod_in, _ = cell.acquire(rx)
    llr = _on_both(ph, "llr", cell.demod, demod_in, dev, cpu)
    mag = np.abs(llr["cpu"])
    _backend_gate(ph, "llr", llr["dev"], llr["cpu"],
                  LLR_ATOL + LLR_RTOL * mag)
    ph.note(f"llr: |LLR| median {float(np.median(mag)):.3g}, share at the "
            f"+-10 clip {float((mag >= 10.0).mean()):.4g}")
    return ph


def phase_cox_acq(dev, batch=COX_BATCH) -> Phase:
    import bench
    return _acq_phase("cox_acq", bench.build_cox_acq(batch), 13, dev)[0]


def _cli_roundtrip(tmp, waveform: str) -> bool:
    from projectultra import cli
    msg = f"smoke {waveform}"
    path = os.path.join(tmp, f"{waveform}.f32")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc_tx = cli.main(["ptx", msg, "-s", "W1AW", "-d", "VE3ABC",
                          "-w", waveform, "-o", path])
        rc_rx = cli.main(["prx", path, "-w", waveform])
    return rc_tx == 0 and rc_rx == 0 and f'Message: "{msg}"' in err.getvalue()


def _decode_golden(name, waveform=None):
    from projectultra.modem.engine import ModemEngine
    audio = np.fromfile(os.path.join(GOLDEN_DIR, name), dtype=np.float32)
    modem = ModemEngine()
    if waveform is not None:
        modem.set_waveform_mode(waveform)
    frames, pings = [], []
    modem.on_frame = frames.append
    modem.on_ping = pings.append
    modem.feed_audio(np.concatenate([audio, np.zeros(8000, np.float32)]))
    modem.poll()
    return frames, pings


def _golden_gates(ph: Phase):
    """The frames tests/test_ref_interop.py asserts, from the reference
    binary's own transmissions."""
    from projectultra.protocol import frame_v2 as F

    frames, pings = _decode_golden("ref_cli_tx_ping.f32")
    ph.gate("ref_ping", len(pings), len(pings) == 1 and not frames)
    frames, _ = _decode_golden("ref_cli_tx_connect.f32")
    cf = F.ConnectFrame.deserialize(frames[0].frame_bytes) \
        if len(frames) == 1 else None
    ph.gate("ref_connect", cf is not None, cf is not None
            and (cf.src_callsign, cf.dst_callsign) == ("AA1AA", "BB2BB"))
    frames, _ = _decode_golden("ref_cli_tx_disconnect.f32")
    ph.gate("ref_disconnect", len(frames), len(frames) == 1
            and frames[0].header.type == F.FrameType.DISCONNECT)
    for name, wf, text in (
            ("ref_cli_tx_ofdm.f32", F.WaveformMode.OFDM_COX,
             "interop payload 123"),
            ("ref_cli_tx_dpsk_mapped.f32", None, "dpsk interop")):
        frames, _ = _decode_golden(name, wf)
        df = F.DataFrame.deserialize(frames[0].frame_bytes) \
            if len(frames) == 1 else None
        ph.gate(name.removesuffix(".f32"), df is not None,
                df is not None and df.payload_as_text() == text)


def _session_gates(ph: Phase, snr_db=15.0):
    """Two stations over AWGN, as tools/cli_simulator.py runs them:
    connect, a message, a small file, disconnect."""
    import jax
    import jax.numpy as jnp
    from projectultra.protocol.engine import ProtocolEngine
    from projectultra.sim import watterson as W

    key = jax.random.PRNGKey(42)
    count = [0]

    def channel(audio):
        count[0] += 1
        a = jnp.asarray(np.concatenate([np.zeros(2000, np.float32), audio,
                                        np.zeros(4000, np.float32)])[None])
        return np.asarray(W.add_noise_active(
            jax.random.fold_in(key, count[0]), a, snr_db))[0]

    a, b = ProtocolEngine(), ProtocolEngine()
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(snr_db)
    a.on_tx_audio = lambda audio: b.feed_audio(channel(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio))
    messages, files = [], []
    b.connection.on_message_received = messages.append

    ph.gate("session_connect", a.connect("VE3ABC"),
            a.connection.is_connected and b.connection.is_connected)
    a.send_message("smoke session message")
    ph.gate("session_message", messages == ["smoke session message"])
    content = b"smoke file over the air, chunked and ARQ'd. " * 8
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "smoke.txt")
        with open(src, "wb") as f:
            f.write(content)
        b.connection.file_transfer.receive_dir = os.path.join(tmp, "rx")
        os.makedirs(b.connection.file_transfer.receive_dir)
        b.connection.file_transfer.on_received = \
            lambda path, ok: files.append((path, ok))
        sent = a.connection.send_file(src)
        for _ in range(30):
            if files:
                break
            a.tick(1000)
            b.tick(1000)
        got = None
        if files and files[0][1]:
            with open(files[0][0], "rb") as f:
                got = f.read()
    ph.gate("session_file", got == content, sent and got == content)
    a.disconnect()
    a.tick(60000)
    b.tick(60000)
    ph.gate("session_disconnect", not b.connection.is_connected,
            not a.connection.is_connected and not b.connection.is_connected)


def phase_modem() -> Phase:
    """The user-facing path: CLI, engine on reference audio, a session."""
    from projectultra import native
    ph = Phase("modem")
    with tempfile.TemporaryDirectory() as tmp:
        for waveform in ("ofdm", "mcdpsk", "dpsk"):
            ok = _cli_roundtrip(tmp, waveform)
            ph.gate(f"cli_{waveform}", ok)
    _golden_gates(ph)
    _session_gates(ph)
    ph.note("host runtime: " + ("native g++ build" if native.available()
                                else "pure-Python fallback"))
    return ph


def phase_multi(devices, acq_frames=MULTI_ACQ_FRAMES,
                pipeline_frames=MULTI_PIPELINE_FRAMES) -> Phase:
    """Frame-axis sharding over `devices` against the same call on the
    first device alone: the counts must be identical."""
    import jax
    import jax.numpy as jnp
    from projectultra.config import CodeRate, Modulation
    from projectultra.fec import ldpc
    from projectultra.ofdm import pipeline as P
    from projectultra.parallel import dcn
    from projectultra.parallel import mesh as mesh_mod

    ph = Phase("multi")
    n = len(devices)
    cfg = P.chirp_ofdm_config()
    mod, rate = Modulation.DQPSK, CodeRate.R1_2
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(5)
    info = rng.integers(0, 2, (pipeline_frames, code.k)).astype(np.float32)
    noise = (MULTI_NOISE_STD * rng.standard_normal(
        (pipeline_frames, P.frame_samples(cfg, mod)))).astype(np.float32)
    totals = {}
    # The sharded run goes first, so each card's peak memory is its own.
    for k in (n, 1):
        mesh = jax.sharding.Mesh(np.array(devices[:k]), ("frames",))
        step = mesh_mod.sharded_pipeline_step(cfg, mod, rate, mesh)
        out, ok, tot = step(*mesh_mod.shard_frames(mesh, info, noise))
        totals[k] = np.asarray(tot).tolist()
        placed = sorted({s.device.id for s in out.addressable_shards})
        rows = {s.data.shape[0] for s in out.addressable_shards}
        ph.gate(f"pipeline_shards_{k}dev", placed,
                len(placed) == k and rows == {pipeline_frames // k})
        if k > 1 and devices[0].platform == "gpu":
            peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devices]
            ph.gate("peak_bytes_per_device", peaks,
                    max(peaks) < 2 * min(peaks))
    ph.gate(f"pipeline_totals_{n}dev", totals[n], totals[n] == totals[1])
    ph.gate("pipeline_totals_1dev", totals[1], True)

    many = dcn.acq_sweep_counts(B=acq_frames, devices=devices)
    one = dcn.acq_sweep_counts(B=acq_frames, devices=devices[:1])
    ph.gate(f"acq_counts_{n}dev", many, many == one)
    ph.gate("acq_counts_1dev", one, True)
    return ph


def _run(ph_fn, *args, **kwargs) -> Phase:
    ph = ph_fn(*args, **kwargs)
    print(ph.line(), flush=True)
    for note in ph.notes:
        print(f"  {ph.name}: {note}", flush=True)
    if not ph.ok:
        raise SmokeFailure(f"phase {ph.name} failed its gates")
    return ph


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help=f"run only the {MULTI_DEVICES}-GPU sharding check")
    args = ap.parse_args(argv)

    # The CPU reference comparison needs the host backend beside the card.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    from projectultra.utils import backend
    t0 = time.perf_counter()
    gpu_lines = backend.gpu_name_and_power_limit()  # before JAX opens a card
    import jax
    device = check_device(jax.devices())
    print(f"phase=device ok=True smoke_wall_s={time.perf_counter() - t0:.3f}"
          f" | platform={device['platform']} kind={device['kind']!r}"
          f" count={device['count']}", flush=True)
    for line in gpu_lines:
        print(f"nvidia-smi: {line}", flush=True)
    print(f"compile cache: {backend.enable_compile_cache()}", flush=True)

    devices = jax.devices()
    if args.multi:
        if len(devices) < MULTI_DEVICES:
            raise SmokeFailure(f"--multi needs {MULTI_DEVICES} GPUs, "
                               f"found {len(devices)}")
        _run(phase_multi, devices[:MULTI_DEVICES])
    else:
        dev, cpu = devices[0], jax.devices("cpu")[0]
        _run(phase_pipeline, dev, cpu)
        _run(phase_chirp_acq, dev, cpu)
        _run(phase_cox_acq, dev)
        os.environ["ULTRA_ACCEL"] = "1"  # the CLI runs on the GPU, or fails
        _run(phase_modem)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
