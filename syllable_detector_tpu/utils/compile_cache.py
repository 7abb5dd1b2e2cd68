"""Persistent XLA compile cache shared by every entry point.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself);
otherwise the cache lives at a fixed directory inside the checkout
(``.jax_cache/``, listed in .gitignore). The path is part of the cache's
key, so a fixed path is what lets a second process hit it.
"""

from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
