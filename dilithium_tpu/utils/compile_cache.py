"""Where JAX keeps its persistent compilation cache for this library.

`JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache is
`<checkout>/.jax_cache` (listed in .gitignore), found from this file's
location so that it follows the checkout wherever it is copied. No other
cache directory is set anywhere in the code.
"""

from __future__ import annotations

import os
from typing import Optional

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cache_dir() -> str:
    """The compilation cache directory (see module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable() -> Optional[str]:
    """Point JAX's persistent compilation cache at `cache_dir()`.

    Returns the directory, or None on the CPU backend, which stays
    uncached: serializing XLA:CPU executables has been seen to crash.
    """
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
