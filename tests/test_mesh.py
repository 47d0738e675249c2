"""Multi-device frame-parallel pipeline on the 8-virtual-CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from projectultra.config import Modulation, CodeRate
from projectultra.fec import ldpc
from projectultra.ofdm import pipeline as P
from projectultra.parallel import mesh as mesh_mod


def test_sharded_pipeline_8_devices():
    assert len(jax.devices()) >= 8
    mesh = mesh_mod.frame_mesh(8)
    cfg = P.chirp_ofdm_config()
    code = ldpc.get_code(CodeRate.R1_2)
    B = 16  # 2 frames per device

    rng = np.random.default_rng(0)
    info = jnp.asarray(rng.integers(0, 2, (B, code.k)).astype(np.float32))
    T = P.frame_samples(cfg, Modulation.DQPSK)
    noise = jnp.asarray(0.02 * rng.standard_normal((B, T)).astype(np.float32))
    info, noise = mesh_mod.shard_frames(mesh, info, noise)

    step = mesh_mod.sharded_pipeline_step(cfg, Modulation.DQPSK,
                                          CodeRate.R1_2, mesh)
    out, ok, totals = step(info, noise)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), np.asarray(info, np.uint8))
    assert float(np.asarray(totals)[0]) == 0.0  # bit errors psum
    assert float(np.asarray(totals)[1]) == 0.0  # frame errors psum
