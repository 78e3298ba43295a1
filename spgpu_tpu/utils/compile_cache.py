"""JAX persistent compilation cache for the repository's entry points.

``bench.py``, ``chip_smoke.py`` and ``__graft_entry__.py`` call
:func:`use_compile_cache` before anything compiles.  The cache directory
is part of the cache key, so it must not move between runs: a directory
the caller names in ``JAX_COMPILATION_CACHE_DIR`` wins (JAX reads it
itself, and nothing else is set); otherwise the fixed ``.jax_cache/``
inside the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

__all__ = ["use_compile_cache"]

_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", _DEFAULT)
    return _DEFAULT
