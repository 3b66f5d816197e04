"""Placement of JAX's persistent compilation cache.

A cold run compiles every rollout, which on the card takes seconds to
minutes per shape. The cache directory is part of the cache key, so it must
not move between runs: either the environment names it
(``JAX_COMPILATION_CACHE_DIR``, which JAX itself reads at start-up), or it is
the fixed ``.jax_cache/`` at the root of this checkout (listed in
``.gitignore``).
"""

from __future__ import annotations

import os
from collections.abc import Mapping

__all__ = ["CACHE_ENV", "cache_dir", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """The directory the persistent compilation cache should use."""
    return environ.get(CACHE_ENV) or os.path.join(_CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``; returns
    the directory. When the environment names a directory, JAX already uses
    it and no other is set."""
    import jax

    path = cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
