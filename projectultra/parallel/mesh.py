"""Device-mesh helpers: frame-axis data parallelism for sweeps and pipelines.

The domain's only parallel axis is frames (SURVEY.md §2.6 — embarrassingly
parallel; the only algorithmically-required collective is the psum of
aggregate BER/FER counts).  These helpers shard any [B, ...] frame batch
over a 1-D mesh, which suits cards joined all to all (NVLink); the
interconnect carries only the metric reductions, and a network between
hosts would only appear for multi-host sweeps.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Spec


def frame_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=("frames",))


def shard_frames(mesh: Mesh, *arrays):
    """Place [B, ...] arrays with the leading axis split over the mesh."""
    sh = NamedSharding(mesh, Spec("frames"))
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]


def pmapped_metrics(mesh: Mesh, step: Callable):
    """Wrap a per-shard step(info, noise) -> (out, ok) into a shard_map that
    also psums [bit_errors, frame_errors] over the mesh."""
    from jax import shard_map

    def wrapped(info, noise):
        out, ok = step(info, noise)
        bit_errors = jnp.sum(out.astype(jnp.float32) != info)
        frame_errors = jnp.sum(~ok).astype(jnp.float32)
        totals = jax.lax.psum(jnp.stack([bit_errors, frame_errors]), "frames")
        return out, ok, totals

    return jax.jit(shard_map(
        wrapped, mesh=mesh,
        in_specs=(Spec("frames"), Spec("frames")),
        out_specs=(Spec("frames"), Spec("frames"), Spec()),
        check_vma=False))


def sharded_pipeline_step(config, mod, rate, mesh: Mesh):
    """The flagship frame pipeline sharded over a mesh: returns a jitted
    step(info [B,k], noise [B,T]) with B divisible by the mesh size."""
    from ..ofdm import pipeline as P

    def step(info, noise):
        tx = P.tx_frame(config, mod, rate, info)
        rx_in = tx + noise
        out, ok, _ = P.rx_frame(config, mod, rate, rx_in)
        return out, ok

    return pmapped_metrics(mesh, step)
