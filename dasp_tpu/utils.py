"""Shared runtime utilities."""

from __future__ import annotations

import os


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set
    (JAX reads the variable itself; no other directory is set here), and
    otherwise in ``<checkout>/.jax_cache``: a fixed path, because the path
    is part of the cache key and a moving directory never hits.  Every
    plan shape compiles once per process without it; the reference has no
    analog (its CUDA kernels are compiled ahead of time).
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
