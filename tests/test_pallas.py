"""Pallas kernel tests: the kept GPU kernels (BC7, BC6H, ETC2 family) run
through the Pallas interpreter on the CPU (`interpret=True`, passed
explicitly) and must be bit-exact against the golden vectors and the
jnp decoders the engine table falls back to.  The engine table's choice
of kernel is checked from its lowering: CUDA gets the Triton kernel,
the CPU the jnp decoder.  The compiled kernels run on the card in
tests/test_gpu.py and chip_smoke.py."""

import functools

import jax
import numpy as np
import pytest

from detex_tpu import engine
from detex_tpu import formats as F
from detex_tpu.ops import bptc_fast
from detex_tpu.ops import etc as etcj
from detex_tpu.ops.bitops import words_from_bytes
from detex_tpu.ops.pallas import (bptc_float_pallas, bptc_pallas,
                                  etc_eac_pallas)


def _bytes(pix, valid):
    out = np.ascontiguousarray(np.asarray(pix)).view(np.uint32) \
        .view(np.uint8).reshape(pix.shape[0], -1)
    valid = np.asarray(valid)
    return np.where(valid[:, None], out, 0).astype(np.uint8), valid


def _check_goldens(family, fn, golden):
    """fn(words, mode_mask, flags) -> (payload words, valid) must equal
    the golden native bytes (invalid blocks zero-filled) for the
    corpus / random blocks and every mode-mask/flags variant."""
    g = golden(family)
    cases = [(g[f"{p}_blocks"], 0xFFFFFFFF, 0, f"{p}_")
             for p in ("corpus", "random") if f"{p}_blocks" in g]
    vi = 0
    while f"variant{vi}_out" in g:
        cases.append((g["random_blocks"], int(g[f"variant{vi}_mask"]),
                      int(g[f"variant{vi}_flags"]), f"variant{vi}_"))
        vi += 1
    for blocks, mask, flags, key in cases:
        out, valid = _bytes(*fn(words_from_bytes(blocks), mask, flags))
        np.testing.assert_array_equal(valid, g[key + "valid"],
                                      err_msg=f"{family} {key}")
        np.testing.assert_array_equal(out, g[key + "out"],
                                      err_msg=f"{family} {key}")


def _interp(fn):
    return functools.partial(fn, interpret=True)


def _bc6h(signed):
    return functools.partial(bptc_float_pallas.decode_bptc_float_packed,
                             signed=signed)


# family -> (kernel in the table's row layout, jnp decoder, block bytes)
_KERNELS = {
    "BPTC": (bptc_pallas.decode_bptc, bptc_fast.decode_bptc_fast, 16),
    "BPTC_FLOAT": (_bc6h(False),
                   engine._DECODERS[F.IDX_BPTC_FLOAT][0].fallback, 16),
    "BPTC_SIGNED_FLOAT": (
        _bc6h(True), engine._DECODERS[F.IDX_BPTC_SIGNED_FLOAT][0].fallback,
        16),
    "ETC2": (etc_eac_pallas.decode_etc2, etcj.decode_etc2, 8),
    "ETC2_PUNCHTHROUGH": (etc_eac_pallas.decode_etc2_punchthrough,
                          etcj.decode_etc2_punchthrough, 8),
    "ETC2_EAC": (etc_eac_pallas.decode_etc2_eac, etcj.decode_etc2_eac, 16),
}
_ETC = ["ETC2", "ETC2_PUNCHTHROUGH", "ETC2_EAC"]


def _vs_jnp(family, n, seed, mask=0xFFFFFFFF, flags=0):
    """Random blocks (n not a multiple of the block: padding path):
    kernel == the table's jnp fallback, pixels and validity."""
    k_fn, j_fn, bs = _KERNELS[family]
    rng = np.random.default_rng(seed)
    w = words_from_bytes(rng.integers(0, 256, (n, bs), np.uint8))
    p0, v0 = j_fn(w, mask, flags)
    p1, v1 = _interp(k_fn)(w, mask, flags)
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))


def test_bptc_pallas_goldens(golden):
    _check_goldens("BPTC", _interp(bptc_pallas.decode_bptc), golden)


def test_bptc_pallas_random_vs_fast():
    _vs_jnp("BPTC", 2048, 7)


@pytest.mark.parametrize("family", _ETC)
def test_etc_eac_pallas_goldens(family, golden):
    _check_goldens(family, _interp(_KERNELS[family][0]), golden)


@pytest.mark.parametrize("family", _ETC)
def test_etc_eac_pallas_random_vs_jnp(family):
    _vs_jnp(family, 1500, 11)


@pytest.mark.parametrize("family,signed", [("BPTC_FLOAT", False),
                                           ("BPTC_SIGNED_FLOAT", True)])
def test_bc6h_pallas_goldens(family, signed, golden):
    _check_goldens(family, _interp(_bc6h(signed)), golden)


@pytest.mark.parametrize("signed", [False, True])
def test_bc6h_pallas_random_vs_jnp(signed):
    _vs_jnp("BPTC_SIGNED_FLOAT" if signed else "BPTC_FLOAT", 1000, 13,
            0x2AAA)


@pytest.mark.parametrize("family", ["BPTC_FLOAT", "BPTC_SIGNED_FLOAT"])
def test_packed_payload_vs_goldens(family, golden):
    """The packed kernel's little-endian byte stream IS the reference
    pixel_buffer layout (detex.h:879-930): 128 B per block, no write
    amplification, equal to the golden native bytes."""
    g = golden(family)
    pk, _ = _interp(_KERNELS[family][0])(
        words_from_bytes(g["random_blocks"]))
    assert pk.shape[1] * 4 == 128
    _check_goldens(family, _interp(_KERNELS[family][0]), golden)


@pytest.mark.parametrize("family", list(_KERNELS))
@pytest.mark.parametrize("mask,flags", [(0x55555555, 0x1),
                                        (0xFFFFFFFF, 0x2),
                                        (0xFFFFFFFF, 0x4)])
def test_kernel_mask_flags_vs_jnp(family, mask, flags):
    """Mode masks and every validity flag: kernel == jnp decoder."""
    _vs_jnp(family, 1000, 17, mask, flags)


def test_bptc_pallas_planar_and_padding():
    # N not a multiple of the block exercises the padding path.
    rng = np.random.default_rng(8)
    blocks = rng.integers(0, 256, (1000, 16), np.uint8)
    w = words_from_bytes(blocks)
    p0, v0 = bptc_fast.decode_bptc_fast(w)
    pix, valid = bptc_pallas.decode_bptc_planar(np.asarray(w).T,
                                                interpret=True)
    assert pix.shape == (16, 1000) and valid.shape == (1000,)
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(pix).T)
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(valid))


def test_bptc_pallas_all_partitions_vs_jnp():
    """Directed sweep of every partition id through the 2- and
    3-subset modes: exercises the packed anchor-position tree and the
    prefix-popcount anchors-before derivation for all 64 psids, not
    just the random draw."""
    rng = np.random.default_rng(21)
    blocks = []
    for mode, pb_bits in ((0, 4), (1, 6), (2, 6), (3, 6), (7, 6)):
        for psid in range(1 << pb_bits):
            b = rng.integers(0, 256, 16, np.uint8)
            # mode prefix: lowest set bit at `mode`, then psid bits
            bits = (1 << mode) | (psid << (mode + 1))
            b[0] = bits & 0xFF
            if mode + 1 + pb_bits > 8:
                b[1] = (bits >> 8) & 0xFF
            blocks.append(b)
    w = words_from_bytes(np.stack(blocks))
    p0, v0 = bptc_fast.decode_bptc_fast(w)
    p1, v1 = _interp(bptc_pallas.decode_bptc)(w)
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))


@pytest.mark.parametrize("family", list(_KERNELS))
def test_table_lowers_kernel_for_cuda_only(family):
    """The table entry lowers to the Triton kernel for CUDA and to the
    plain jnp decoder for the CPU — the choice is per lowering, with no
    interpreter on either path."""
    dec = engine.device_decoder(getattr(F, family))
    w = np.zeros((256, _KERNELS[family][2] // 4), np.int32)
    traced = jax.jit(dec).trace(w, np.uint32(0xFFFFFFFF), np.uint32(0))
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "__gpu$xla.gpu.triton" in cuda
    assert "triton" not in cpu
    assert engine.decoder_name(getattr(F, family), "gpu") \
        .startswith("triton:")
    assert engine.decoder_name(getattr(F, family), "cpu").startswith("xla:")
