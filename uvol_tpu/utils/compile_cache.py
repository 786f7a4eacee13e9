"""One place that decides where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os

#: the checkout's own cache directory: a fixed path, because the path is
#: part of the cache key and a moving directory never hits
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns the directory in use.

    With `JAX_COMPILATION_CACHE_DIR` set, JAX already uses it and nothing
    is changed. Otherwise the cache goes to `<checkout>/.jax_cache`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
