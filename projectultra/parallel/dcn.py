"""Multi-host (DCN) sweep scaling: process-sharded frame axis.

SURVEY §2.6: the single-host mesh (parallel/mesh.py, sweep.py) rides the
cards' own interconnect; a network between hosts is only needed to scale
SWEEPS across hosts.  The recipe here is the
jax-native one: `jax.distributed.initialize` per process, ONE global mesh
over every process's devices, global arrays built from per-process local
shards, and a single jit'd program whose cross-shard reductions XLA lowers
to collectives over whatever transport connects the processes (gloo/TCP on
the CPU, NCCL between GPUs).

The workload is the acquisition-inclusive MC-DPSK sweep (the
parallel/sweep.py run_point_mc_dpsk path): full dual-chirp detection ->
per-frame dynamic slice -> demod at detected CFO -> LDPC -> global counts.
Every process builds the same deterministic host inputs, places only its
local shards, and receives fully-replicated counts — so a 2-process x
4-device run must produce EXACTLY the counts of a 1-process x 8-device run
(pinned by tools/dcn_sweep.py and tests/test_dcn_sweep.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import CodeRate
from ..fec import ldpc
from ..ops import ldpc as ldpc_ops
from ..psk import mc_dpsk as MC
from ..sim import watterson as W
from ..sync import chirp as chirp_mod


def build_inputs(B: int, seed: int = 7):
    """Deterministic host-side sweep inputs, identical on every process."""
    mc = MC.level10()
    cc = mc.chirp_config()
    code = ldpc.get_code(CodeRate.R1_4)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    cw = np.asarray(ldpc_ops.encode(code, jnp.asarray(info)))
    lead = 4800
    pre = np.concatenate([chirp_mod.generate(cc), MC.generate_training(mc),
                          MC.generate_reference(mc)])
    data = np.asarray(MC.modulate(mc, jnp.asarray(cw)))
    tx = np.concatenate([
        np.zeros((B, lead), np.float32),
        np.broadcast_to(pre.astype(np.float32), (B, len(pre))),
        data.astype(np.float32),
        np.zeros((B, 4000), np.float32)], axis=-1)
    return mc, cc, code, info, tx


def acq_sweep_counts(B: int = 16, snr_db: float = 5.0, seed: int = 7,
                     devices=None) -> dict:
    """Global acquisition sweep over all participating devices/processes.

    Returns {"decoded": int, "found": int, "bit_errors": int} — replicated
    across processes, bit-identical regardless of the process/device
    topology sharding the frame axis.
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mc, cc, code, info, tx = build_inputs(B, seed)
    n_sym = MC.num_symbols_for_bits(mc, code.n)
    span_len = (mc.training_samples + mc.ref_samples
                + n_sym * mc.samples_per_symbol)

    devs = np.array(devices if devices is not None else jax.devices())
    mesh = Mesh(devs, ("frames",))
    sh = NamedSharding(mesh, P("frames"))
    rep = NamedSharding(mesh, P())

    def put(host_arr):
        # Each process materializes only ITS addressable shards.
        return jax.make_array_from_callback(
            host_arr.shape, sh, lambda idx: host_arr[idx])

    tx_g = put(tx)
    info_g = put(info)

    def prog(tx_g, info_g):
        # Channel noise inside the program: threefry bits are
        # value-deterministic regardless of sharding, so every topology
        # sees the same noise.
        rx = W.add_noise_active(jax.random.PRNGKey(seed + 1), tx_g, snr_db)
        det = chirp_mod.detect_dual_chirp(cc, rx,
                                          threshold=mc.chirp_threshold)
        tr = chirp_mod.training_start(cc, det["down_chirp_start"])
        T = rx.shape[-1]
        starts = jnp.clip(tr, 0, T - span_len)
        span = jax.vmap(lambda b, s: jax.lax.dynamic_slice(
            b, (s,), (span_len,)))(rx, starts)
        llrs = MC.demodulate_presynced(mc, span, det["cfo_hz"],
                                       tr.astype(jnp.float32), n_sym)
        out, ok, _ = ldpc_ops.decode(code, llrs[:, :code.n])
        bits_match = (out == info_g.astype(jnp.uint8)).all(-1)
        good = ok & det["success"] & bits_match
        errs = (out != info_g.astype(jnp.uint8)).sum()
        return (good.sum().astype(jnp.int32),
                det["success"].sum().astype(jnp.int32),
                errs.astype(jnp.int32))

    decoded, found, errs = jax.jit(
        prog, out_shardings=(rep, rep, rep))(tx_g, info_g)
    return {"decoded": int(np.asarray(decoded)),
            "found": int(np.asarray(found)),
            "bit_errors": int(np.asarray(errs))}
