"""BC1/BC1A/BC2/BC3 (S3TC/DXT) block decoders — batched, branch-free.

Batched redesign of the reference's per-block C decoders
(reference: decompress-bc.c:23-240).  Instead of per-pixel loops and
branches, both interpolation modes are computed for the whole batch and
selected with `where`; indices for all 16 pixels are extracted with a
static unrolled shift (vector ops, no gathers).

All decoders take little-endian int32 words (see ops.bitops.words_from_bytes)
and return (pixels, valid):
  BC1/BC1A/BC2/BC3: pixels int32 (N, 16) packed RGBA8, valid bool (N,).
Semantics matched bit-for-bit against the reference (tests/golden):
  * 565 endpoint expansion is shift-only (<<3 / <<2), no low-bit
    replication (decompress-bc.c:34-39)
  * 4-color interpolation uses truncating division by 3 of (2a+b)
    (decompress-bc.c:41-46 via the division LUT); 3-color mode uses
    truncating (a+b)/2 and black for index 3 (decompress-bc.c:48-53)
  * BC2 alpha is 4-bit * 255 / 15 (decompress-bc.c:166)
  * BC3 alpha uses truncating /7 and /5 interpolation (decompress-bc.c:210-235)
"""

from __future__ import annotations

import jax.numpy as jnp

from detex_tpu import formats as F
from detex_tpu.ops.bitops import field, has_flag, pack_rgba8, shr

_FULL = 0xFFFFFFFF


def _expand_565(colors):
    """Decode two RGB565 endpoints from one int32 word -> 6 arrays."""
    b0 = field(colors, 0, 5) << 3
    g0 = field(colors, 5, 6) << 2
    r0 = field(colors, 11, 5) << 3
    b1 = field(colors, 16, 5) << 3
    g1 = field(colors, 21, 6) << 2
    r1 = field(colors, 27, 5) << 3
    return r0, g0, b0, r1, g1, b1


def _bc1_palette(colors):
    """Both BC1 palettes (4-color and 3-color) plus the mode predicate.

    Returns (opaque, [c0..c3] per channel) where entries 2/3 are already
    mode-selected.  All values 0..255 in int32.
    """
    r0, g0, b0, r1, g1, b1 = _expand_565(colors)
    c0 = jnp.bitwise_and(colors, 0xFFFF)
    c1 = shr(colors, 16)
    opaque = c0 > c1

    def mix(a, b):
        four_2 = (2 * a + b) // 3
        four_3 = (a + 2 * b) // 3
        three_2 = (a + b) // 2
        c2 = jnp.where(opaque, four_2, three_2)
        c3 = jnp.where(opaque, four_3, 0)
        return c2, c3

    r2, r3 = mix(r0, r1)
    g2, g3 = mix(g0, g1)
    b2, b3 = mix(b0, b1)
    return opaque, (r0, r1, r2, r3), (g0, g1, g2, g3), (b0, b1, b2, b3)


def _select4(idx, c):
    """Select from a 4-entry palette tuple by per-pixel index (N, 16)."""
    c0, c1, c2, c3 = (x[:, None] for x in c)
    return jnp.where(idx == 0, c0,
                     jnp.where(idx == 1, c1,
                               jnp.where(idx == 2, c2, c3)))


def _color_indices(pixels_word):
    """(N,) int32 word -> (N, 16) 2-bit indices, pixel order i=y*4+x."""
    i = jnp.arange(16, dtype=jnp.int32)
    return jnp.bitwise_and(shr(pixels_word[:, None], (i * 2)[None, :]), 3)


def decode_bc1(words, mode_mask: int = _FULL, flags: int = 0):
    """BC1/DXT1 -> packed RGBA8 with alpha forced 0xFF
    (reference detexDecompressBlockBC1, decompress-bc.c:23-61)."""
    colors = words[:, 0]
    _, r, g, b = _bc1_palette(colors)
    idx = _color_indices(words[:, 1])
    pix = pack_rgba8(_select4(idx, r), _select4(idx, g), _select4(idx, b),
                     jnp.full(idx.shape, 0xFF, jnp.int32))
    valid = jnp.ones(words.shape[0], dtype=bool)
    return pix, valid


def decode_bc1a(words, mode_mask: int = _FULL, flags: int = 0):
    """BC1A: BC1 with 1-bit transparency in 3-color mode
    (reference detexDecompressBlockBC1A, decompress-bc.c:87-132)."""
    colors = words[:, 0]
    opaque, r, g, b = _bc1_palette(colors)
    idx = _color_indices(words[:, 1])
    alpha3 = jnp.where(opaque, 0xFF, 0)
    a = jnp.where(idx == 3, alpha3[:, None], 0xFF)
    pix = pack_rgba8(_select4(idx, r), _select4(idx, g), _select4(idx, b), a)
    valid = jnp.ones(words.shape[0], dtype=bool)
    valid = valid & ~(has_flag(flags, F.FLAG_NON_OPAQUE_ONLY) & opaque)
    valid = valid & ~(has_flag(flags, F.FLAG_OPAQUE_ONLY) & ~opaque)
    return pix, valid


def decode_bc2(words, mode_mask: int = _FULL, flags: int = 0):
    """BC2: BC1 colors (always 4-color) + explicit 4-bit alpha
    (reference detexDecompressBlockBC2, decompress-bc.c:136-171)."""
    colors = words[:, 2]
    r0, g0, b0, r1, g1, b1 = _expand_565(colors)
    r = (r0, r1, (2 * r0 + r1) // 3, (r0 + 2 * r1) // 3)
    g = (g0, g1, (2 * g0 + g1) // 3, (g0 + 2 * g1) // 3)
    b = (b0, b1, (2 * b0 + b1) // 3, (b0 + 2 * b1) // 3)
    idx = _color_indices(words[:, 3])
    i = jnp.arange(16, dtype=jnp.int32)
    # 64-bit alpha field: pixels 0-7 in word 0, 8-15 in word 1.
    alpha_word = jnp.where(i[None, :] < 8, words[:, 0:1], words[:, 1:2])
    a4 = jnp.bitwise_and(shr(alpha_word, (i * 4 % 32)[None, :]), 0xF)
    a = a4 * 255 // 15
    pix = pack_rgba8(_select4(idx, r), _select4(idx, g), _select4(idx, b), a)
    valid = jnp.ones(words.shape[0], dtype=bool)
    c0 = jnp.bitwise_and(colors, 0xFFFF)
    c1 = shr(colors, 16)
    valid = valid & ~(has_flag(flags, F.FLAG_ENCODE) & ~(c0 > c1))
    return pix, valid


def _bc3_alpha(words, byte_off: int = 0):
    """Interpolated 3-bit-coded alpha channel shared by BC3 and RGTC.

    words: (N, k) with the 8-byte alpha block starting at word byte_off
    (must be word-aligned here: BC3/RGTC use offset 0).
    Returns (N, 16) int32 alpha 0..255.
    Reference: decompress-bc.c:177-235.
    """
    w0, w1 = words[:, 0], words[:, 1]
    a0 = field(w0, 0, 8)
    a1 = field(w0, 8, 8)
    seven = a0 > a1
    # 48-bit code stream starts at bit 16 of w0. Pixel i code at bit 16+3i.
    i = jnp.arange(16, dtype=jnp.int32)
    start = 16 + i * 3
    lo_sh = jnp.bitwise_and(start, 31)
    use_w1 = start >= 32
    lo = jnp.where(use_w1[None, :], w1[:, None], w0[:, None])
    hi = jnp.where(use_w1[None, :], 0, w1[:, None])
    lo_part = shr(lo, lo_sh[None, :])
    hi_shift = jnp.bitwise_and(32 - lo_sh, 31)
    hi_part = jnp.where(lo_sh[None, :] == 0, 0,
                        (hi.astype(jnp.uint32)
                         << hi_shift[None, :].astype(jnp.uint32))
                        .astype(jnp.int32))
    code = jnp.bitwise_and(jnp.bitwise_or(lo_part, hi_part), 0x7)

    a0b, a1b = a0[:, None], a1[:, None]
    # 7-step palette (a0 > a1): codes 2..7 interpolate /7
    alpha7 = jnp.where(
        code == 0, a0b,
        jnp.where(code == 1, a1b, ((8 - code) * a0b + (code - 1) * a1b) // 7))
    # 5-step palette: codes 2..5 interpolate /5; 6 -> 0, 7 -> 255
    alpha5 = jnp.where(
        code == 0, a0b,
        jnp.where(code == 1, a1b,
                  jnp.where(code == 6, 0,
                            jnp.where(code == 7, 0xFF,
                                      ((6 - code) * a0b + (code - 1) * a1b)
                                      // 5))))
    return jnp.where(seven[:, None], alpha7, alpha5), a0, a1


def decode_bc3(words, mode_mask: int = _FULL, flags: int = 0):
    """BC3: BC1 colors (always 4-color) + interpolated alpha
    (reference detexDecompressBlockBC3, decompress-bc.c:175-240)."""
    colors = words[:, 2]
    r0, g0, b0, r1, g1, b1 = _expand_565(colors)
    r = (r0, r1, (2 * r0 + r1) // 3, (r0 + 2 * r1) // 3)
    g = (g0, g1, (2 * g0 + g1) // 3, (g0 + 2 * g1) // 3)
    b = (b0, b1, (2 * b0 + b1) // 3, (b0 + 2 * b1) // 3)
    idx = _color_indices(words[:, 3])
    a, a0, a1 = _bc3_alpha(words)
    pix = pack_rgba8(_select4(idx, r), _select4(idx, g), _select4(idx, b), a)
    valid = jnp.ones(words.shape[0], dtype=bool)
    valid = valid & ~(has_flag(flags, F.FLAG_OPAQUE_ONLY) & (a0 > a1))
    c0 = jnp.bitwise_and(colors, 0xFFFF)
    c1 = shr(colors, 16)
    valid = valid & ~(has_flag(flags, F.FLAG_ENCODE) & ~(c0 > c1))
    return pix, valid
