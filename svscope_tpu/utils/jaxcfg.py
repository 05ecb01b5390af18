"""Shared JAX configuration: persistent compilation cache.

XLA compiles of the engine's kernels cost seconds per shape; the on-disk
cache makes them one-time per machine instead of per process.  Imported by
every module that builds jitted kernels.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX
reads that variable itself, so nothing is set here), otherwise a fixed
`.jax_cache/` at the repository root (listed in .gitignore).  The path is
part of the cache key, so it must not move between runs.  A process that
turned `jax_enable_compilation_cache` off (the CPU test suite) gets no
cache directory at all."""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_cache() -> None:
    import jax

    if (not jax.config.jax_enable_compilation_cache
            or os.environ.get("JAX_COMPILATION_CACHE_DIR")):
        return
    if jax.config.jax_compilation_cache_dir is None:
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
