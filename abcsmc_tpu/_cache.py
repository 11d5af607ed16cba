"""Persistent XLA compilation cache.

The fused generation program takes tens of seconds to compile; the
persistent cache makes every later process that compiles the same program
start in seconds. ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as
JAX reads it (no directory is set in code); otherwise the cache lives in the
fixed in-checkout directory ``<repo>/.jax_cache`` - the path is part of the
cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_persistent_cache() -> None:
    """Point JAX's persistent compilation cache at :data:`DEFAULT_DIR`
    unless ``JAX_COMPILATION_CACHE_DIR`` already names one. Starts no
    backend, so a process can still pick its platform afterwards. A process
    held to the CPU (``jax_platforms == "cpu"``) keeps no cache: XLA:CPU
    entries are pinned to the compiling machine's instruction set."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if jax.config.jax_platforms == "cpu":
        return
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
