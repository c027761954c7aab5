"""One place that sets JAX's persistent compilation cache for the scripts.

The library itself sets no cache on import; the measurement scripts and
``chip_smoke.py`` call :func:`enable_compile_cache` once at start-up.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "CHECKOUT_CACHE"]

#: the cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset: a
#: fixed path in the checkout (listed in ``.gitignore``), so a later process
#: in the same checkout finds the programs compiled before.
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing. Otherwise the cache goes to :data:`CHECKOUT_CACHE`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
