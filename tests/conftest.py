"""Test configuration: everything runs on the CPU with 8 virtual devices
(the root conftest pins the platform before jax is imported).

Multi-device sharding tests use the virtual mesh (SURVEY.md §4: CPU with
--xla_force_host_platform_device_count=8, no cluster needed for CI).
Tests marked `gpu` take the `gpu_device` fixture, which skips unless
JAX's first device is a GPU; run them on the card with
DETEX_TEST_GPU=1 python -m pytest -m gpu tests/
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from detex_tpu.utils.compile_cache import use_compile_cache

# Persistent XLA compilation cache: repeat test runs skip recompiles.
use_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

GOLDEN_DIR = Path(__file__).parent / "golden"


@pytest.fixture
def gpu_device():
    """The GPU for a `gpu`-marked test; skips when there is none.
    Decided here, at run time — never while a module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX's first device is "
                    f"{dev.platform!r})")
    return dev


@pytest.fixture(scope="session")
def golden():
    """Loader for golden npz vectors: golden('BC1') -> dict of arrays."""
    cache = {}

    def load(family: str):
        if family not in cache:
            path = GOLDEN_DIR / f"{family}.npz"
            if not path.exists():
                pytest.skip(f"golden vectors missing: {path} "
                            "(run tools/gen_goldens.py)")
            cache[family] = dict(np.load(path))
        return cache[family]

    return load
