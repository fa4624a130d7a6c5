"""RGTC (BC4/BC5, unsigned + signed) block decoders — batched, branch-free.

Batched redesign of the reference per-block decoders
(reference: decompress-rgtc.c:26-147).  The 3-bit code stream layout is
identical to the BC3 alpha block (2 endpoint bytes + 48 code bits), so
the extraction is shared; palettes differ only in the signed mapping.

Bit-exact semantics reproduced:
  * unsigned palette == BC3 alpha palette: truncating /7 (7-step when
    lum0 > lum1) and /5 (5-step + 0/255) interpolation
    (decompress-rgtc.c:35-56 via the division LUTs)
  * signed: int8 endpoints, -128 clamped to -127, the illegal
    (lum0,lum1) = (-127,-128) pair marks the block invalid
    (decompress-rgtc.c:90-96); truncating-toward-zero division
    (detex.h:966-982 signed LUT wrappers multiply by sign); final map
    [-127,127] -> [-32768,32767] via (r+127)*65535/254-32768
    (decompress-rgtc.c:124-126)

Outputs:
  decode_rgtc1        -> ((N,16) int32 in 0..255, valid)         [R8]
  decode_rgtc2        -> ((N,16,2) int32 in 0..255, valid)       [RG8]
  decode_signed_rgtc1 -> ((N,16) int32 in -32768..32767, valid)  [SIGNED_R16]
  decode_signed_rgtc2 -> ((N,16,2) int32, valid)                 [SIGNED_RG16]
"""

from __future__ import annotations

import jax.numpy as jnp

from detex_tpu.ops.bitops import field, shr

_FULL = 0xFFFFFFFF


def _codes3(w0, w1):
    """(N,) int32 word pair -> (N, 16) 3-bit codes starting at bit 16.

    Shared layout of BC3 alpha / RGTC blocks: 48-bit code stream in the
    top 6 bytes of the 8-byte block (decompress-rgtc.c:29, 33, 58).
    """
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
    return jnp.bitwise_and(jnp.bitwise_or(lo_part, hi_part), 0x7)


def _unsigned_channel(w0, w1):
    """One 8-byte unsigned RGTC channel -> (N, 16) values 0..255."""
    lum0 = field(w0, 0, 8)
    lum1 = field(w0, 8, 8)
    code = _codes3(w0, w1)
    l0, l1 = lum0[:, None], lum1[:, None]
    seven = (lum0 > lum1)[:, None]
    val7 = jnp.where(code == 0, l0,
                     jnp.where(code == 1, l1,
                               ((8 - code) * l0 + (code - 1) * l1) // 7))
    val5 = jnp.where(code == 0, l0,
                     jnp.where(code == 1, l1,
                               jnp.where(code == 6, 0,
                                         jnp.where(code == 7, 0xFF,
                                                   ((6 - code) * l0
                                                    + (code - 1) * l1) // 5))))
    return jnp.where(seven, val7, val5)


def _div_trunc(num, den: int):
    """Truncating (toward-zero) integer division, matching the signed
    division-LUT wrappers (detex.h:966-982: sign * table[abs(x)])."""
    return jnp.sign(num) * (jnp.abs(num) // den)


def _signed_channel(w0, w1):
    """One 8-byte signed RGTC channel -> ((N, 16) int32 16-bit-mapped, valid)."""
    lum0_raw = field(w0, 0, 8)
    lum1_raw = field(w0, 8, 8)
    # int8 reinterpretation
    lum0 = lum0_raw - jnp.where(lum0_raw >= 128, 256, 0)
    lum1 = lum1_raw - jnp.where(lum1_raw >= 128, 256, 0)
    valid = ~((lum0 == -127) & (lum1 == -128))
    lum0 = jnp.maximum(lum0, -127)
    lum1 = jnp.maximum(lum1, -127)
    code = _codes3(w0, w1)
    l0, l1 = lum0[:, None], lum1[:, None]
    seven = (lum0 > lum1)[:, None]
    val7 = jnp.where(code == 0, l0,
                     jnp.where(code == 1, l1,
                               _div_trunc((8 - code) * l0 + (code - 1) * l1,
                                          7)))
    val5 = jnp.where(code == 0, l0,
                     jnp.where(code == 1, l1,
                               jnp.where(code == 6, -127,
                                         jnp.where(code == 7, 127,
                                                   _div_trunc(
                                                       (6 - code) * l0
                                                       + (code - 1) * l1,
                                                       5)))))
    result = jnp.where(seven, val7, val5)
    # Map [-127,127] -> [-32768,32767] (decompress-rgtc.c:124-126).
    mapped = (result + 127) * 65535 // 254 - 32768
    return mapped, valid


def decode_rgtc1(words, mode_mask: int = _FULL, flags: int = 0):
    """BC4 unsigned (reference detexDecompressBlockRGTC1,
    decompress-rgtc.c:64-68).  words: (N, 2) int32."""
    vals = _unsigned_channel(words[:, 0], words[:, 1])
    return vals, jnp.ones(words.shape[0], dtype=bool)


def decode_rgtc2(words, mode_mask: int = _FULL, flags: int = 0):
    """BC5 unsigned: two interleaved channels (decompress-rgtc.c:72-77).
    words: (N, 4) int32."""
    r = _unsigned_channel(words[:, 0], words[:, 1])
    g = _unsigned_channel(words[:, 2], words[:, 3])
    return jnp.stack([r, g], axis=-1), jnp.ones(words.shape[0], dtype=bool)


def decode_signed_rgtc1(words, mode_mask: int = _FULL, flags: int = 0):
    """Signed BC4 (decompress-rgtc.c:134-137).  words: (N, 2) int32."""
    vals, valid = _signed_channel(words[:, 0], words[:, 1])
    return vals, valid


def decode_signed_rgtc2(words, mode_mask: int = _FULL, flags: int = 0):
    """Signed BC5 (decompress-rgtc.c:141-147).  words: (N, 4) int32."""
    r, valid_r = _signed_channel(words[:, 0], words[:, 1])
    g, valid_g = _signed_channel(words[:, 2], words[:, 3])
    return jnp.stack([r, g], axis=-1), valid_r & valid_g
