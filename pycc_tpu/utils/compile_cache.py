"""Where JAX keeps its persistent compilation cache.

JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins: the
helper then sets no other directory.  Otherwise the cache lives at
<checkout>/.jax_cache, computed from this file's location, so every entry
point of one checkout shares one cache whatever its working directory
(the path is part of the cache key, so a moving directory never hits).
"""

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir():
    """The compilation-cache directory in use."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def setup_compile_cache():
    """Enable the persistent cache for programs that take at least a
    second to compile; returns the directory."""
    import jax
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
