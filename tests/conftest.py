"""Test environment: the CPU backend with 8 virtual devices.

Bit-exactness is backend-independent (the library uses exact integer ops
everywhere), so the suite runs on the CPU; the multi-device sharding tests
use the 8 virtual CPU devices. XLA_FLAGS must be set before the CPU
backend is first initialized (lazily, at the first jax.devices() call).
Tests that need a GPU carry the `gpu` marker and run their check in a
child process through the `gpu_env` fixture, which skips without a card.
"""

import os
import subprocess
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
# NOTE: the persistent compilation cache is deliberately NOT enabled here —
# serializing XLA:CPU executables has been seen to segfault intermittently
# in compilation_cache.put_executable_and_time.
os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
assert jax.device_count() == 8, "expected 8 virtual CPU devices for sharding tests"

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the GPU.

    Skips when no NVIDIA GPU is found. This process stays on the CPU, so
    the child gets the card to itself.
    """
    try:
        found = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                               text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("needs an NVIDIA GPU: nvidia-smi not available")
    if found.returncode != 0 or "GPU" not in found.stdout:
        pytest.skip("needs an NVIDIA GPU: nvidia-smi lists none")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    return env
