"""Where the persistent compilation cache goes (abcsmc_tpu._cache)."""

import os
import subprocess
import sys

import jax

from abcsmc_tpu._cache import DEFAULT_DIR, enable_persistent_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax\n"
    "from jax._src import xla_bridge\n"
    "from abcsmc_tpu._cache import enable_persistent_cache\n"
    "enable_persistent_cache()\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "print(xla_bridge.backends_are_initialized())\n"
)


def _probe(env_cache_dir):
    """Run the cache set-up in a fresh process whose platform is not held
    to the CPU (as on a machine with a card)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    if env_cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_cache_dir)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout.split()
    return out[-2], out[-1]


def test_cache_dir_from_env_is_left_to_jax(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the program sets no directory in code,
    and setting the cache up starts no backend."""
    cache_dir, started = _probe(tmp_path / "cc")
    assert cache_dir == str(tmp_path / "cc")
    assert started == "False"


def test_cache_dir_defaults_to_checkout():
    """JAX_COMPILATION_CACHE_DIR unset: the fixed in-checkout .jax_cache."""
    cache_dir, started = _probe(None)
    assert cache_dir == DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert started == "False"


def test_cpu_held_process_keeps_no_cache(monkeypatch):
    """A process held to the CPU (as the test suite is) keeps no cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert jax.config.jax_platforms == "cpu"
    enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == before
