"""One persistent XLA compile cache for the programs of this checkout.

The cache's path is part of what makes an entry found again, so it is a
fixed directory: `JAX_COMPILATION_CACHE_DIR` when the environment sets it
(JAX reads that variable itself), otherwise `<checkout>/.jax_cache`.
Call `use_compile_cache()` before the first compilation.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the compile cache lives in."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def use_compile_cache() -> str:
    """Point JAX at cache_dir() unless the environment already does."""
    import jax
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
