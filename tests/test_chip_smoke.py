"""chip_smoke.py and the backend helpers, on the CPU backend at tiny sizes.

The smoke script itself runs on a GPU; here its phase functions run with the
CPU standing in for the card, gates and CPU-reference comparison included,
and its device check must refuse the CPU.
"""

import os

import jax
import pytest

import chip_smoke
from projectultra.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """The env var's directory wins and nothing else is set; without it the
    cache sits at a fixed, git-ignored path inside the checkout."""
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.__setitem__(name, value))
    if env_dir is None:
        monkeypatch.delenv(backend.CACHE_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(backend.CACHE_ENV_VAR, str(tmp_path / env_dir))

    got = backend.enable_compile_cache()

    assert "jax_persistent_cache_min_compile_time_secs" in updates
    if env_dir is None:
        assert got == backend.DEFAULT_CACHE_DIR
        assert updates["jax_compilation_cache_dir"] == got
        assert os.path.dirname(got) == REPO
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert os.path.basename(got) + "/" in f.read().split()
    else:
        assert got == str(tmp_path / env_dir)
        assert "jax_compilation_cache_dir" not in updates


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device(jax.devices("cpu"))


def _phase(name):
    cpu = jax.devices("cpu")[0]
    if name == "pipeline":
        return chip_smoke.phase_pipeline(cpu, cpu, batch=8, compare_frames=8)
    if name == "chirp_acq":
        return chip_smoke.phase_chirp_acq(cpu, cpu, batch=4)
    return chip_smoke.phase_cox_acq(cpu, batch=4)


@pytest.mark.parametrize("name", ["pipeline", "chirp_acq", "cox_acq"])
def test_batched_phase_on_cpu(name):
    ph = _phase(name)
    assert ph.gates and ph.ok, ph.line()
    gates = {g[0] for g in ph.gates}
    if name == "pipeline":
        assert {"eq17dB_max_abs_err", "eq0dB_max_abs_err",
                "llr17dB_max_abs_err", "llr0dB_max_abs_err",
                "ldpc17dB_lanes_equal", "ldpc0dB_lanes_equal"} <= gates
    if name == "chirp_acq":
        assert "llr_max_abs_err" in gates


def test_multi_phase_on_virtual_devices():
    """--multi's comparison on 4 of the virtual CPU devices."""
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    ph = chip_smoke.phase_multi(devices, acq_frames=4, pipeline_frames=8)
    assert ph.ok, ph.line()


@pytest.mark.gpu
def test_pipeline_phase_on_gpu(gpu_devices):
    """The pipeline phase at a small batch on the card, against the CPU."""
    ph = chip_smoke.phase_pipeline(gpu_devices[0], jax.devices("cpu")[0],
                                   batch=256, compare_frames=64)
    assert ph.ok, ph.line()
