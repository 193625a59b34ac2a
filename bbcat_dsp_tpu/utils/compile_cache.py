"""Where the runnable scripts keep JAX's persistent compilation cache.

Called by ``chip_smoke.py``, ``bench.py`` and ``scripts/`` at start-up,
never at library import.  If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here.  Otherwise the cache goes to a
fixed directory inside the checkout (``<checkout>/.jax_cache``, listed in
``.gitignore``): the path is part of the cache key, so a directory that
moved between runs would never hit.
"""

from __future__ import annotations

import os

__all__ = ["configure_compile_cache"]

_CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the checkout's
    ``.jax_cache`` unless ``JAX_COMPILATION_CACHE_DIR`` already names one.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", _CHECKOUT_CACHE_DIR)
    return _CHECKOUT_CACHE_DIR
