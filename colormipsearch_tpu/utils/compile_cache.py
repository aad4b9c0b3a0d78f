"""Persistent XLA compile cache location.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, that
directory is the cache and nothing here overrides it. Otherwise every
entry point (the CLI, bench.py, chip_smoke.py) uses one fixed directory
inside the checkout, `<repo>/.jax_cache` (git-ignored), so separate
processes of one checkout reuse each other's compiled kernels.
"""

from __future__ import annotations

import os
import pathlib

REPO_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[2]
                     / ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache lives in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at cache_dir(); returns it."""
    import jax
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
