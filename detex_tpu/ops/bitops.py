"""Batched bit-manipulation primitives on uint32 words.

Batched replacement for the reference's serial bitstring reader
(reference: bits.h:21-61, bits.c:22-44).  Blocks are structure-of-arrays:
a batch of 64-bit blocks is an int32 array of shape (N, 2) and a 128-bit
batch is (N, 4), little-endian word order, matching the byte layout the
C reference reads on little-endian hosts.

Everything works on int32 (JAX default; uint semantics recovered with
masks) so kernels never touch 64-bit ints.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def words_from_bytes(blocks_u8):
    """(N, 4*k) uint8 -> (N, k) int32 little-endian words (bit-preserving)."""
    blocks_u8 = np.ascontiguousarray(blocks_u8, dtype=np.uint8)
    return jnp.asarray(blocks_u8.view(np.uint32).astype(np.int64)
                       .astype(np.uint32).view(np.int32))


def bytes_from_words(words) -> np.ndarray:
    """(N, k) int32 words -> (N, 4*k) uint8 little-endian bytes."""
    return np.ascontiguousarray(np.asarray(words)).view(np.uint32) \
        .astype(np.uint32).view(np.uint8)


def u32(x):
    return jnp.asarray(x).view(jnp.uint32) if hasattr(x, "view") else x


def _shr_impl(x, n):
    """Logical (unsigned) right shift of int32 by per-element/static n."""
    xu = x.astype(jnp.uint32) if x.dtype != jnp.uint32 else x
    if isinstance(n, int):
        return (xu >> jnp.uint32(n)).astype(jnp.int32)
    return (xu >> n.astype(jnp.uint32)).astype(jnp.int32)


shr = _shr_impl


def field(word, start: int, width: int):
    """Static bitfield [start, start+width) from a single int32 word array."""
    assert 0 <= start and start + width <= 32
    mask = (1 << width) - 1
    return jnp.bitwise_and(_shr_impl(word, start), mask)


def field64(lo, hi, start: int, width: int):
    """Static bitfield from a 64-bit quantity given as (lo, hi) int32 words.

    Equivalent of reference detexGetBits64 (bits.h:30-32) with static
    arguments, restricted to width <= 31 so results fit int32.
    """
    assert width <= 31 and start + width <= 64
    if start + width <= 32:
        return field(lo, start, width)
    if start >= 32:
        return field(hi, start - 32, width)
    lo_bits = 32 - start
    lo_part = _shr_impl(lo, start)
    hi_part = jnp.bitwise_and(hi, (1 << (width - lo_bits)) - 1)
    return jnp.bitwise_or(lo_part, hi_part << lo_bits)


def field_words(words, start: int, width: int):
    """Static bitfield from (N, k) int32 word array (any start < 32*k)."""
    assert width <= 31
    w0 = start // 32
    lo = words[..., w0]
    if start % 32 + width <= 32:
        return field(lo, start % 32, width)
    hi = words[..., w0 + 1]
    return field64(lo, hi, start % 32, width)


def dyn_field(words, start, width: int):
    """Bitfield at *dynamic* per-element start (int32 array), static width.

    words: (..., k) int32; start: (...,) int32 in [0, 32*k - width].
    Returns (...,) int32.  Implemented as a two-word funnel shift with
    take_along_axis gathers — fully vectorized, no data-dependent control
    flow (replaces the serial cursor of reference bits.c:22-44).
    """
    assert width <= 31
    k = words.shape[-1]
    # Allow `start` to carry extra trailing dims relative to the words'
    # batch shape (e.g. per-pixel starts (N, 16) over (N, k) words).
    extra = start.ndim - (words.ndim - 1)
    w = words
    for _ in range(extra):
        w = w[..., None, :]
    w0 = _shr_impl(start, 5)  # start // 32
    bit = jnp.bitwise_and(start, 31)
    lo = jnp.take_along_axis(w, w0[..., None], axis=-1)[..., 0]
    w1 = jnp.minimum(w0 + 1, k - 1)
    hi = jnp.take_along_axis(w, w1[..., None], axis=-1)[..., 0]
    lo_part = _shr_impl(lo, bit)
    # (hi << (32-bit)) — when bit == 0 the hi part must vanish; (32-bit)
    # would be an UB shift by 32, so mask it out explicitly.
    hi_shift = jnp.bitwise_and(32 - bit, 31)
    hi_part = jnp.where(bit == 0, 0, (hi.astype(jnp.uint32)
                                      << hi_shift.astype(jnp.uint32))
                        .astype(jnp.int32))
    out = jnp.bitwise_or(lo_part, hi_part)
    return jnp.bitwise_and(out, (1 << width) - 1)


def dyn_field_vw(words, start, width, max_width: int):
    """Dynamic start AND dynamic width (<= max_width <= 16)."""
    raw = dyn_field(words, start, max_width)
    mask = _shr_impl(jnp.full_like(width, -1), 32 - width)
    mask = jnp.where(width == 0, 0, mask)
    return jnp.bitwise_and(raw, mask)


def reversed_field64(lo, hi, start: int, width: int):
    """Bitfield read MSB-first (reference detexGetBitsRev64, bits.h:35-47):
    bit `start` becomes the MSB of the result, bit start-width+1 the LSB."""
    out = jnp.zeros_like(lo)
    for i in range(width):
        bit = field64(lo, hi, start - i, 1)
        out = jnp.bitwise_or(out, bit << (width - 1 - i))
    return out


def interleave_u16_pairs(lo16, hi16):
    """Pack two int32 arrays holding 16-bit values into one int32."""
    return jnp.bitwise_or(jnp.bitwise_and(lo16, 0xFFFF), hi16 << 16)


def _as_u32_scalar(x):
    if isinstance(x, int):
        return np.uint32(x & 0xFFFFFFFF)
    return x


def has_flag(flags, bit: int):
    """Traceable flag test: works for Python ints and traced scalars.

    Returning a jnp bool scalar keeps decoder validity logic inside one
    compiled graph per family — mode_mask/flags are runtime inputs, not
    static compile-time constants."""
    f = jnp.asarray(_as_u32_scalar(flags)).astype(jnp.uint32)
    return jnp.not_equal(jnp.bitwise_and(f, jnp.uint32(bit)), 0)


def mask_bit(mask, bit_index):
    """Traceable `(mask >> bit_index) & 1 != 0` with array bit_index."""
    idx = jnp.clip(bit_index, 0, 31).astype(jnp.uint32)
    m = jnp.asarray(_as_u32_scalar(mask)).astype(jnp.uint32)
    return jnp.not_equal(jnp.bitwise_and(m >> idx, jnp.uint32(1)), 0)


def pack_rgba8(r, g, b, a):
    """Pack 8-bit components into a little-endian RGBA8 uint32-as-int32
    (reference detexPack32RGBA8, detex.h:1006-1016)."""
    return (jnp.bitwise_and(r, 0xFF)
            | (jnp.bitwise_and(g, 0xFF) << 8)
            | (jnp.bitwise_and(b, 0xFF) << 16)
            | (jnp.bitwise_and(a, 0xFF) << 24))


def pack_u8x4(vals):
    """(N, 4k) 8-bit values -> (N, k) little-endian words, 4 per word."""
    v = jnp.bitwise_and(vals, 0xFF).reshape(vals.shape[0], -1, 4)
    return (v[:, :, 0] | (v[:, :, 1] << 8) | (v[:, :, 2] << 16)
            | (v[:, :, 3] << 24))


def pack_u16x2(vals):
    """(N, 2k) 16-bit values (signed ones as their u16 pattern) ->
    (N, k) little-endian words, 2 per word."""
    v = jnp.bitwise_and(vals, 0xFFFF).reshape(vals.shape[0], -1, 2)
    return v[:, :, 0] | (v[:, :, 1] << 16)
