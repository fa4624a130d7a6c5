"""Tests that need an NVIDIA GPU: the compiled Triton kernels of the
engine decoder table against the native oracle.  They skip elsewhere;
on the card run `DETEX_TEST_GPU=1 python -m pytest -m gpu tests/`."""

import jax
import numpy as np
import pytest

from detex_tpu import engine, native
from detex_tpu.utils.blocks import FAMILIES, random_blocks, texture_format

_KERNEL_FAMILIES = [f for f in FAMILIES if hasattr(
    engine.device_decoder(texture_format(f)), "gpu_kernel")]


@pytest.mark.gpu
@pytest.mark.parametrize("family", _KERNEL_FAMILIES)
def test_compiled_kernel_vs_native(gpu_device, family):
    fmt = texture_format(family)
    assert engine.decoder_name(fmt).startswith("triton:")
    blocks = random_blocks(np.random.default_rng(3), family, 1 << 16)
    got, valid = engine.decode_blocks(fmt, blocks, backend="jax")
    want, want_valid = native.decode(family, blocks)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(got[want_valid], want[want_valid])
    assert jax.devices()[0] == gpu_device
