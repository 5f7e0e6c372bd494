"""Platform-facing choices that the CPU can check: the service mode
`auto` resolves to, the compilation-cache location, and the GPU entry
points refusing to run (and printing no result) without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from dilithium_tpu import api
from dilithium_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode,platform,expected", [
    ("auto", "gpu", "mxu"),
    ("auto", "cpu", "batch"),
    ("mxu", "cpu", "mxu"),
    ("batch", "gpu", "batch"),
])
def test_resolve_mode(mode, platform, expected):
    assert api.resolve_mode(mode, platform) == expected


@pytest.mark.parametrize("mode,platform", [("auto", "rocm"), ("fast", "gpu")])
def test_resolve_mode_rejects(mode, platform):
    with pytest.raises(ValueError):
        api.resolve_mode(mode, platform)


def test_auto_mode_here_is_batch():
    assert api.resolve_mode("auto") == "batch"  # the suite runs on the CPU


def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_not_enabled_on_cpu():
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() is None
    assert jax.config.jax_compilation_cache_dir == before


def _run_cpu(script, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    r = _run_cpu(script, REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "value" not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_cpu("chip_smoke.py", str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
