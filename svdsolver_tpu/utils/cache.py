"""Persistent compilation cache location.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here changes.  Otherwise the cache goes to ``<checkout>/.jax_cache`` (listed
in ``.gitignore``): a fixed path, because the path is part of the cache key.
"""

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache():
    """Point JAX's persistent compilation cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return DEFAULT_DIR
