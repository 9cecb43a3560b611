"""Persistent compilation cache placement (utils/cache.py)."""

import os

import jax
import pytest

from pyskani_tpu.utils import cache


@pytest.fixture
def gpu_backend(monkeypatch):
    """Pretend an accelerator backend; record config updates instead of
    applying them, so the CPU suite never enables a persistent cache."""
    updates = {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: updates.__setitem__(name, val))
    monkeypatch.setattr(cache, "_enabled", False)
    monkeypatch.setattr(cache.os, "makedirs", lambda *a, **k: None)
    return updates


def test_env_dir_is_honoured(gpu_backend, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set in code
    assert "jax_compilation_cache_dir" not in gpu_backend


def test_default_is_checkout_root(gpu_backend, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert cache.enable_compilation_cache() == want
    assert gpu_backend["jax_compilation_cache_dir"] == want
    # idempotent: a second call changes nothing
    gpu_backend.clear()
    assert cache.enable_compilation_cache() == want
    assert gpu_backend == {}


def test_cpu_backend_is_a_no_op(monkeypatch):
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: updates.__setitem__(name, val))
    monkeypatch.setattr(cache, "_enabled", False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax.default_backend() == "cpu"
    assert cache.enable_compilation_cache() == ""
    assert updates == {}
