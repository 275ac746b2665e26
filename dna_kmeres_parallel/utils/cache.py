"""Where the program keeps its XLA compile cache and its calibration.

JAX_COMPILATION_CACHE_DIR, when set, names the directory and JAX reads it
itself; otherwise both live in ``.jax_cache/`` at the root of the checkout
(listed in .gitignore). No other location is used.
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _ROOT, ".jax_cache"
    )


def enable_compile_cache() -> None:
    """Persistent XLA compilation cache: first-compile latency is paid once
    per program shape across runs, not per run."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
