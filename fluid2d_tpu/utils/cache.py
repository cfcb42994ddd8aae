"""Persistent XLA compilation cache.

A res≥1600 step takes tens of seconds to compile; the persistent cache
lets later processes reuse it. The CLI, ``bench.py`` and
``chip_smoke.py`` call :func:`enable_compile_cache` once, after the
platform is settled.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CHECKOUT_CACHE_DIR", "cache_dir_for", "enable_compile_cache"]

# Fixed, so that every run from this checkout finds the entries of the
# last one: a directory named after a pid, a time or a temporary name is
# never found again.
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir_for(backend: str, env_dir: str | None) -> str | None:
    """Where the program itself should point the cache, if anywhere.

    * ``JAX_COMPILATION_CACHE_DIR`` set → None: JAX reads the variable
      itself, and the program sets no directory of its own.
    * CPU backend → None: XLA:CPU cache entries are not portable across
      hosts (machine-feature mismatches on reload), and CPU compiles at
      test sizes are cheap.
    * otherwise → ``<checkout>/.jax_cache``.
    """
    if env_dir or backend == "cpu":
        return None
    return str(CHECKOUT_CACHE_DIR)


def enable_compile_cache() -> str | None:
    """Apply :func:`cache_dir_for` to this process. Returns the cache
    directory in effect (JAX's own from the environment, the checkout's,
    or None when off). Resolves the backend, so call it after any
    ``jax.config.update("jax_platforms", ...)``."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = cache_dir_for(jax.default_backend(), env_dir)
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir or env_dir or None
