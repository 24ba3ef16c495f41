"""Where JAX keeps its persistent compile cache.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache goes to one fixed directory,
``.jax_cache`` beside the package (the checkout root when running from
a source tree), so that later processes find what earlier ones compiled:
the directory is part of the cache key, and one that moves never hits.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it.

    A directory already chosen (by the variable or by an earlier
    ``jax.config.update``) is left as it is."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "").strip()
    if env:
        return env
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
