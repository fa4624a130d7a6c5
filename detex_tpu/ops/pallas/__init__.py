"""Pallas block-decode kernels, compiled for the GPU through Triton.

Each kernel is a fused single-pass decoder over word-planar blocks:
words (k, N) int32 in, packed payload words (n_out, N) int32 plus (N,)
validity out.  `planar_call` is the one pallas_call wrapper they share.
The route is named (`backend="triton"`); interpret mode runs only when
a caller passes `interpret=True` (the CPU tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["planar_call"]

# Blocks and warps per program: 128 blocks on 4 warps is one block per
# thread.  (512 blocks per program decoded no faster on an H100.)
BLOCK = 128
NUM_WARPS = 4


def _to_i32_scalar(x):
    if isinstance(x, (int, np.integer)):
        return ((int(x) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return x


@functools.partial(jax.jit, static_argnames=("kernel", "n_out", "interpret"))
def _call(words_planar, scal, kernel, n_out: int, interpret: bool):
    n_words, n = words_planar.shape
    block = BLOCK
    n_pad = -(-n // block) * block
    wp = jnp.pad(words_planar, ((0, 0), (0, n_pad - n)))
    wp = wp.reshape(n_words, 1, n_pad)
    # Inside shard_map the outputs vary over the same mesh axes as the
    # words (block decode is per block).
    vma = jax.typeof(wp).vma
    pix, valid = pl.pallas_call(
        kernel,
        grid=(n_pad // block,),
        in_specs=[
            pl.BlockSpec((2,), lambda i: (0,)),
            pl.BlockSpec((n_words, 1, block), lambda i: (0, 0, i)),
        ],
        out_specs=[
            pl.BlockSpec((n_out, 1, block), lambda i: (0, 0, i)),
            pl.BlockSpec((1, block), lambda i: (0, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_out, 1, n_pad), jnp.int32, vma=vma),
            jax.ShapeDtypeStruct((1, n_pad), jnp.int32, vma=vma),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
    )(scal, wp)
    return (pix.reshape(n_out, n_pad)[:, :n],
            valid.reshape(n_pad)[:n] != 0)


def planar_call(kernel, words_planar, mode_mask, flags, n_out: int, *,
                interpret: bool = False):
    """Run `kernel(scal_ref, words_ref, pix_ref, valid_ref)` over (k, N)
    planar words, BLOCK blocks per program.  The kernel reads word i of
    its blocks as `words_ref[i]` ((1, BLOCK) int32), writes output word
    j as `pix_ref[j] = ...` and the validity as `valid_ref[...] = ...`;
    `scal_ref` holds [mode_mask, flags].  Returns ((n_out, N) int32,
    (N,) bool)."""
    scal = jnp.asarray([_to_i32_scalar(mode_mask), _to_i32_scalar(flags)],
                       jnp.int32)
    return _call(words_planar, scal, kernel, n_out, bool(interpret))
