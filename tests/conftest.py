"""Test configuration: run everything on a virtual 8-device CPU mesh with x64
enabled, so numerics tests match the reference's double precision and sharding
tests exercise multi-device layouts without a GPU.

Tests that need an NVIDIA GPU carry the ``gpu`` marker (``pytest -m gpu``).
They run their payload in a child process that is not held to the CPU, and
skip, from inside the ``gpu_python`` fixture, when that child finds no GPU."""

import os
import subprocess
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# jax may already have been imported by a pytest plugin, with its config
# latched from the environment at that time - override
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gpu_env() -> dict:
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


@pytest.fixture(scope="session")
def gpu_python():
    """A runner for Python source in a child process on the GPU; skips the
    test when the child's JAX finds no GPU. One child at a time uses the
    card, and this process never opens it."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=_gpu_env(), cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    platform = probe.stdout.strip().splitlines()[-1] if probe.stdout else ""
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found {platform or 'none'!r}")

    def run(source: str, timeout: float = 900) -> str:
        out = subprocess.run(
            [sys.executable, "-c", source], env=_gpu_env(), cwd=REPO,
            capture_output=True, text=True, timeout=timeout,
        )
        assert out.returncode == 0, out.stderr[-4000:]
        return out.stdout

    return run
