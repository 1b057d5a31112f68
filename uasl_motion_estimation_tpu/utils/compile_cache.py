"""Persistent XLA compilation cache for the entry scripts.

Library code sets no cache; scripts that users run (``chip_smoke.py``,
``bench.py``, ``benchmarks/*.py``) call ``enable_compile_cache`` once, before
their first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``JAX_COMPILATION_CACHE_DIR``
    when that is set, else at ``<checkout>/.jax_cache``; returns the path."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
