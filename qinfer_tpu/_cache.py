"""Persistent compilation cache location for the scripts of this repository.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands (JAX reads
it itself) and no other directory is set in code. Otherwise the cache lives
in ``.jax_cache`` at the root of the checkout: a fixed path, because the
path is part of the cache key and a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

#: ``<checkout>/.jax_cache`` (listed in ``.gitignore``)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache():
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
