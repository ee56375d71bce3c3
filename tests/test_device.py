"""utils/device.py: the device-capability decision and the compile-cache
directory, and the branch-and-bound's use of the former."""

import jax
import numpy as np
import pytest

from ortools_tpu.utils import device


def test_cpu_is_not_an_accelerator():
    assert jax.default_backend() == "cpu"
    assert not device.is_accelerator()
    assert not device.is_accelerator("cpu")


def test_gpu_backend_is_an_accelerator(monkeypatch):
    assert device.is_accelerator("gpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert device.is_accelerator()


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_environment(monkeypatch, cache_config,
                                           tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    repo = __file__.rsplit("/tests/", 1)[0]
    assert path == f"{repo}/.jax_cache"
    assert jax.config.jax_compilation_cache_dir == path


def _set_cover_after_fj(monkeypatch, accelerator: bool) -> list:
    """Run mip.solve with device_fj="auto" and record whether the device
    feasibility jump was called."""
    from ortools_tpu.mip import branch_and_bound as bb
    from ortools_tpu.models.mip_generators import set_cover
    from ortools_tpu.sat import fj_device

    calls = []

    def fake_fj(*args, **kw):
        calls.append(kw.get("n_seeds"))
        return fj_device.DeviceFjResult([], 0, 0.0, 0.0)

    monkeypatch.setattr(bb, "is_accelerator", lambda: accelerator)
    monkeypatch.setattr(fj_device, "device_feasibility_jump", fake_fj)
    qp = set_cover(40, 20, seed=1)
    res = bb.solve(qp, bb.MipParams(device_fj="auto", time_limit_sec=60.0,
                                    local_branching_interval=0))
    assert np.isfinite(res.objective_value)
    return calls


def test_device_fj_auto_stays_off_on_cpu(monkeypatch):
    assert _set_cover_after_fj(monkeypatch, accelerator=False) == []


def test_device_fj_auto_engages_on_gpu(monkeypatch):
    assert _set_cover_after_fj(monkeypatch, accelerator=True) == [64]

