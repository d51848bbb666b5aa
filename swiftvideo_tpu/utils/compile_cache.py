"""JAX's persistent compilation cache, kept at one fixed place.

A cold process compiles every device program again; with the cache a
second run (or a second process) loads them.  The cache's key includes its
path, so the directory must not move between runs: no temp, pid or time
component.
"""

from __future__ import annotations

import os

#: the checkout's own cache directory (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at its directory and return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to ``DEFAULT_DIR``, the
    ``.jax_cache`` directory at the root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
