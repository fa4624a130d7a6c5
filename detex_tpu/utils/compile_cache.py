"""One place that decides where JAX keeps its persistent compile cache.

Every entry point (chip_smoke.py, bench.py, the CLIs, the tools, the
tests) calls `use_compile_cache()` before its first compilation.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DEFAULT_DIR = REPO / ".jax_cache"


def cache_dir() -> Path:
    """JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_DIR


def use_compile_cache() -> Path:
    """Point JAX's persistent compile cache at `cache_dir()`.  When
    JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing
    is set here."""
    import jax
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
