"""Persistent compilation cache location, shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
nothing is set here. Otherwise the cache goes to ``.jax_cache`` at the
root of the checkout (git-ignored). The path is part of the cache key, so
it is fixed rather than per-user or per-run.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns the path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
