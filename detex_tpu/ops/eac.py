"""EAC decoders: ETC2_EAC alpha path and EAC R11/RG11 (signed + unsigned).

Batched redesign of the reference per-block decoders
(reference: decompress-eac.c:44-231).  The reference assembles a
big-endian qword and walks pixels column-major with a serial shift; here
every pixel's 3-bit index is a static bitfield over byteswapped words,
computed for the whole batch at once.

Bit-exact semantics reproduced:
  * 16x8 modifier table (decompress-eac.c:21-38)
  * column-major pixel transpose out[(i&3)*4 + (i>>2)]
    (decompress-eac.c:48,125,199)
  * 11-bit path: base*8+4, multiplier*8 (min 1), clamp [0,2047],
    replicate (v<<5)|(v>>6) to 16 bits (decompress-eac.c:113-127)
  * signed 11-bit: int8 base, base == -128 -> invalid block
    (decompress-eac.c:183-185), clamp [-1023,1023], sign-preserving
    replication (v<<5)|(v>>5) on the magnitude (decompress-eac.c:167-173)

Outputs:
  decode_eac_alpha       -> ((N,16) int32 0..255, valid)   [alpha bytes]
  decode_eac_r11         -> ((N,16) int32 u16, valid)      [R16]
  decode_eac_rg11        -> ((N,16,2) int32 u16, valid)    [RG16]
  decode_eac_signed_r11  -> ((N,16) int32 i16, valid)      [SIGNED_R16]
  decode_eac_signed_rg11 -> ((N,16,2) int32 i16, valid)    [SIGNED_RG16]
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from detex_tpu import formats as F
from detex_tpu.ops.bitops import field, field64, has_flag

_FULL = 0xFFFFFFFF

# decompress-eac.c:21-38
EAC_MODIFIER_TABLE = np.array([
    [-3, -6, -9, -15, 2, 5, 8, 14],
    [-3, -7, -10, -13, 2, 6, 9, 12],
    [-2, -5, -8, -13, 1, 4, 7, 12],
    [-2, -4, -6, -13, 1, 3, 5, 12],
    [-3, -6, -8, -12, 2, 5, 7, 11],
    [-3, -7, -9, -11, 2, 6, 8, 10],
    [-4, -7, -8, -11, 3, 6, 7, 10],
    [-3, -5, -8, -11, 2, 4, 7, 10],
    [-2, -6, -8, -10, 1, 5, 7, 9],
    [-2, -5, -8, -10, 1, 4, 7, 9],
    [-2, -4, -8, -10, 1, 3, 7, 9],
    [-2, -5, -7, -10, 1, 4, 6, 9],
    [-3, -4, -7, -10, 2, 3, 6, 9],
    [-1, -2, -3, -10, 0, 1, 2, 9],
    [-4, -6, -8, -9, 3, 5, 7, 8],
    [-3, -5, -7, -9, 2, 4, 6, 8],
], dtype=np.int32)

# For output pixel j the reference's loop variable is i = (j&3)*4 + (j>>2)
# (the transpose is an involution); its 3-bit index sits at big-endian qword
# bit 45 - 3*i.
_J = np.arange(16)
_SRC_I = (_J & 3) * 4 + (_J >> 2)
_BIT_START = (45 - 3 * _SRC_I).tolist()


def bswap32(w):
    """Byte-swap each int32 lane (little-endian word -> big-endian)."""
    wu = w.astype(jnp.uint32)
    out = ((wu >> 24) | ((wu >> 8) & 0xFF00)
           | ((wu & 0xFF00) << 8) | (wu << 24))
    return out.astype(jnp.int32)


def _pixel_codes(w0, w1):
    """(N,) word pair (little-endian bytes 0-3 / 4-7) -> (N, 16) 3-bit
    codes, already transposed to row-major output pixel order."""
    be_hi = bswap32(w0)   # big-endian qword bits 32..63
    be_lo = bswap32(w1)   # bits 0..31
    cols = [field64(be_lo, be_hi, s, 3) for s in _BIT_START]
    return jnp.stack(cols, axis=-1)


def _modifiers(w0, w1, table):
    """Per-pixel modifier values: table[byte1 & 0xF][code]."""
    tab = jnp.asarray(table)
    tidx = field(w0, 8, 4)                  # byte 1 low nibble
    code = _pixel_codes(w0, w1)             # (N, 16)
    return tab[tidx[:, None], code], code


def decode_eac_alpha(w0, w1, flags: int = 0):
    """8-bit EAC alpha channel of ETC2_EAC (decompress-eac.c:54-86).
    w0/w1: (N,) int32 words of the 8-byte alpha block.
    Returns ((N, 16) int32 alpha, valid)."""
    base = field(w0, 0, 8)
    multiplier = field(w0, 12, 4)           # byte 1 high nibble
    mod, _ = _modifiers(w0, w1, EAC_MODIFIER_TABLE)
    val = jnp.clip(base[:, None] + mod * multiplier[:, None], 0, 255)
    valid = jnp.ones(w0.shape[0], dtype=bool)
    valid = valid & ~(has_flag(flags, F.FLAG_ENCODE) & (multiplier == 0))
    return val, valid


def _eac11_channel(w0, w1):
    """Unsigned 11-bit channel (decompress-eac.c:111-128) -> (N,16) u16."""
    base8p4 = (field(w0, 0, 8) << 3) | 0x4
    mult8 = field(w0, 12, 4) << 3
    mult8 = jnp.where(mult8 == 0, 1, mult8)
    mod, _ = _modifiers(w0, w1, EAC_MODIFIER_TABLE)
    v = jnp.clip(base8p4[:, None] + mod * mult8[:, None], 0, 2047)
    return (v << 5) | (v >> 6)


def _eac11_signed_channel(w0, w1):
    """Signed 11-bit channel (decompress-eac.c:180-202) -> ((N,16) i16,
    valid)."""
    base_raw = field(w0, 0, 8)
    base = base_raw - jnp.where(base_raw >= 128, 256, 0)
    valid = base != -128
    base8 = base << 3
    mult8 = field(w0, 12, 4) << 3
    mult8 = jnp.where(mult8 == 0, 1, mult8)
    mod, _ = _modifiers(w0, w1, EAC_MODIFIER_TABLE)
    v = jnp.clip(base8[:, None] + mod * mult8[:, None], -1023, 1023)
    mag = jnp.abs(v)
    rep = (mag << 5) | (mag >> 5)
    return jnp.sign(v) * rep, valid


def decode_eac_r11(words, mode_mask: int = _FULL, flags: int = 0):
    """EAC_R11 (decompress-eac.c:132-140).  words: (N, 2) int32."""
    vals = _eac11_channel(words[:, 0], words[:, 1])
    return vals, jnp.ones(words.shape[0], dtype=bool)


def decode_eac_rg11(words, mode_mask: int = _FULL, flags: int = 0):
    """EAC_RG11 (decompress-eac.c:144-157).  words: (N, 4) int32."""
    r = _eac11_channel(words[:, 0], words[:, 1])
    g = _eac11_channel(words[:, 2], words[:, 3])
    return jnp.stack([r, g], axis=-1), jnp.ones(words.shape[0], dtype=bool)


def decode_eac_signed_r11(words, mode_mask: int = _FULL, flags: int = 0):
    """EAC_SIGNED_R11 (decompress-eac.c:206-213).  words: (N, 2) int32."""
    return _eac11_signed_channel(words[:, 0], words[:, 1])


def decode_eac_signed_rg11(words, mode_mask: int = _FULL, flags: int = 0):
    """EAC_SIGNED_RG11 (decompress-eac.c:217-231).  words: (N, 4) int32."""
    r, valid_r = _eac11_signed_channel(words[:, 0], words[:, 1])
    g, valid_g = _eac11_signed_channel(words[:, 2], words[:, 3])
    return jnp.stack([r, g], axis=-1), valid_r & valid_g
