"""Backend set-up shared by the entry points: compile cache and device checks.

The persistent compilation cache lives in one place.  If
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
sets another directory.  Otherwise the cache goes to ``.jax_cache`` at the
root of the checkout (listed in ``.gitignore``).  The path is fixed because
it is part of the cache key: a directory that moves never hits.
"""

from __future__ import annotations

import os
import subprocess

CACHE_ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")
# Programs cheaper than this to compile are not written to the cache.
MIN_COMPILE_TIME_SECS = 0.5

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; return its directory."""
    import jax
    path = os.environ.get(CACHE_ENV_VAR)
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_TIME_SECS)
    return path


def require_gpu(devices=None) -> list:
    """Return JAX's devices; raise RuntimeError unless they are GPUs.

    There is no CPU fallback: a measurement or an accelerator run that
    finds no GPU fails instead of quietly computing on the host.
    """
    if devices is None:
        import jax
        devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {platform!r} "
            f"({devices[0].device_kind})")
    return list(devices)


def gpu_name_and_power_limit() -> list[str]:
    """`nvidia-smi`'s name and power limit, one line per card.

    Runs nvidia-smi in a child process, which never opens the card through
    JAX, so it can be called before or after JAX takes the card.  Raises
    if nvidia-smi is missing or fails.
    """
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
