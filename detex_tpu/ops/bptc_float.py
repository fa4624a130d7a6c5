"""BPTC_FLOAT / BPTC_SIGNED_FLOAT (BC6H) block decoder — batched, branch-free.

Batched redesign of the reference per-block decoder
(reference: decompress-bptc-float.c:110-644).  The reference's giant
14-mode switch of hand-written bit scatters (decompress-bptc-float.c:128-485)
becomes *data*: a per-mode field-descriptor table driving static
bitfield extraction; all 14 modes are decoded for the whole batch and
each block selects its own by the detected mode.

Bit-exact semantics reproduced:
  * 2-then-5-bit mode code via the map-mode table
    (decompress-bptc-float.c:23-33); unmappable codes -> invalid block
  * every per-mode field scatter, incl. the reversed-bit fields of
    modes 12/13 (decompress-bptc-float.c:451-484; detexGetBits64Reversed
    maps the *highest* memory bit to the LSB, bits.h:34-47)
  * delta endpoints: sign-extend, add mod 2^EPB, re-sign-extend when
    signed (decompress-bptc-float.c:496-518)
  * unquantize to the 17-bit work range (decompress-bptc-float.c:52-86)
  * anchored 3/4-bit index streams (decompress-bptc-float.c:543-564)
  * final scale *31/64 (unsigned) or *31>>5 with sign-magnitude
    half-float assembly (signed) (decompress-bptc-float.c:576-622)

Input: (N, 4) little-endian int32 words.  Output: ((N, 16, 4) int32
uint16-valued FLOAT_RGBX16 components (X = 0), (N,) bool valid).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from detex_tpu.ops.bitops import dyn_field, field, field_words, mask_bit
from detex_tpu.ops.bptc import _ANCHOR2, _P2, _WEIGHTS

_FULL = 0xFFFFFFFF

# decompress-bptc-float.c:23-26
_MAP_MODE = np.array([
    0, 1, 2, 10, -1, -1, 3, 11, -1, -1, 4, 12, -1, -1, 5, 13,
    -1, -1, 6, -1, -1, -1, 7, -1, -1, -1, 8, -1, -1, -1, 9, -1,
], dtype=np.int32)

# decompress-bptc-float.c:42-43
_EPB = [10, 7, 11, 11, 11, 9, 8, 8, 8, 6, 10, 11, 12, 16]

# Per-mode delta bits (r, g, b); None = untransformed endpoints
# (decompress-bptc-float.c mode cases; modes 9/10 have no deltas).
_DELTA = [
    (5, 5, 5), (6, 6, 6), (5, 4, 4), (4, 5, 4), (4, 4, 5),
    (5, 5, 5), (6, 5, 5), (5, 6, 5), (5, 5, 6), None,
    None, (9, 9, 9), (8, 8, 8), (4, 4, 4),
]

# Field scatter per mode: (dest, lo, hi, shift, reversed).
# dest is 'r0'..'b3'; lo..hi are inclusive absolute bit positions in the
# 128-bit block; `reversed` maps bit hi -> LSB (modes 12/13).
# Transcribed from the switch decompress-bptc-float.c:128-485 (data1
# positions offset by +64).
_FIELDS = [
    # mode 0 (:129-155)
    [("g2", 2, 2, 4), ("b2", 3, 3, 4), ("b3", 4, 4, 4), ("r0", 5, 14, 0),
     ("g0", 15, 24, 0), ("b0", 25, 34, 0), ("r1", 35, 39, 0),
     ("g3", 40, 40, 4), ("g2", 41, 44, 0), ("g1", 45, 49, 0),
     ("b3", 50, 50, 0), ("g3", 51, 54, 0), ("b1", 55, 59, 0),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 69, 0), ("b3", 70, 70, 2), ("r3", 71, 75, 0),
     ("b3", 76, 76, 3)],
    # mode 1 (:156-187)
    [("g2", 2, 2, 5), ("g3", 3, 3, 4), ("g3", 4, 4, 5), ("r0", 5, 11, 0),
     ("b3", 12, 12, 0), ("b3", 13, 13, 1), ("b2", 14, 14, 4),
     ("g0", 15, 21, 0), ("b2", 22, 22, 5), ("b3", 23, 23, 2),
     ("g2", 24, 24, 4), ("b0", 25, 31, 0), ("b3", 32, 32, 3),
     ("b3", 33, 33, 5), ("b3", 34, 34, 4), ("r1", 35, 40, 0),
     ("g2", 41, 44, 0), ("g1", 45, 50, 0), ("g3", 51, 54, 0),
     ("b1", 55, 60, 0), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 70, 0), ("r3", 71, 76, 0)],
    # mode 2 (:188-214)
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 39, 0), ("r0", 40, 40, 10), ("g2", 41, 44, 0),
     ("g1", 45, 48, 0), ("g0", 49, 49, 10), ("b3", 50, 50, 0),
     ("g3", 51, 54, 0), ("b1", 55, 58, 0), ("b0", 59, 59, 10),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 69, 0), ("b3", 70, 70, 2), ("r3", 71, 75, 0),
     ("b3", 76, 76, 3)],
    # mode 3 (:215-244)
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 38, 0), ("r0", 39, 39, 10), ("g3", 40, 40, 4),
     ("g2", 41, 44, 0), ("g1", 45, 49, 0), ("g0", 50, 50, 10),
     ("g3", 51, 54, 0), ("b1", 55, 58, 0), ("b0", 59, 59, 10),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 68, 0), ("b3", 69, 69, 0), ("b3", 70, 70, 2),
     ("r3", 71, 74, 0), ("g2", 75, 75, 4), ("b3", 76, 76, 3)],
    # mode 4 (:245-274)
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 38, 0), ("r0", 39, 39, 10), ("b2", 40, 40, 4),
     ("g2", 41, 44, 0), ("g1", 45, 48, 0), ("g0", 49, 49, 10),
     ("b3", 50, 50, 0), ("g3", 51, 54, 0), ("b1", 55, 59, 0),
     ("b0", 60, 60, 10), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 68, 0), ("b3", 69, 69, 1), ("b3", 70, 70, 2),
     ("r3", 71, 74, 0), ("b3", 75, 75, 4), ("b3", 76, 76, 3)],
    # mode 5 (:275-301)
    [("r0", 5, 13, 0), ("b2", 14, 14, 4), ("g0", 15, 23, 0),
     ("g2", 24, 24, 4), ("b0", 25, 33, 0), ("b3", 34, 34, 4),
     ("r1", 35, 39, 0), ("g3", 40, 40, 4), ("g2", 41, 44, 0),
     ("g1", 45, 49, 0), ("b3", 50, 50, 0), ("g3", 51, 54, 0),
     ("b1", 55, 59, 0), ("b3", 60, 60, 1), ("b2", 61, 63, 0),
     ("b2", 64, 64, 3), ("r2", 65, 69, 0), ("b3", 70, 70, 2),
     ("r3", 71, 75, 0), ("b3", 76, 76, 3)],
    # mode 6 (:302-329)
    [("r0", 5, 12, 0), ("g3", 13, 13, 4), ("b2", 14, 14, 4),
     ("g0", 15, 22, 0), ("b3", 23, 23, 2), ("g2", 24, 24, 4),
     ("b0", 25, 32, 0), ("b3", 33, 33, 3), ("b3", 34, 34, 4),
     ("r1", 35, 40, 0), ("g2", 41, 44, 0), ("g1", 45, 49, 0),
     ("b3", 50, 50, 0), ("g3", 51, 54, 0), ("b1", 55, 59, 0),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 70, 0), ("r3", 71, 76, 0)],
    # mode 7 (:330-360)
    [("r0", 5, 12, 0), ("b3", 13, 13, 0), ("b2", 14, 14, 4),
     ("g0", 15, 22, 0), ("g2", 23, 23, 5), ("g2", 24, 24, 4),
     ("b0", 25, 32, 0), ("g3", 33, 33, 5), ("b3", 34, 34, 4),
     ("r1", 35, 39, 0), ("g3", 40, 40, 4), ("g2", 41, 44, 0),
     ("g1", 45, 50, 0), ("g3", 51, 54, 0), ("b1", 55, 59, 0),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 69, 0), ("b3", 70, 70, 2), ("r3", 71, 75, 0),
     ("b3", 76, 76, 3)],
    # mode 8 (:361-391)
    [("r0", 5, 12, 0), ("b3", 13, 13, 1), ("b2", 14, 14, 4),
     ("g0", 15, 22, 0), ("b2", 23, 23, 5), ("g2", 24, 24, 4),
     ("b0", 25, 32, 0), ("b3", 33, 33, 5), ("b3", 34, 34, 4),
     ("r1", 35, 39, 0), ("g3", 40, 40, 4), ("g2", 41, 44, 0),
     ("g1", 45, 49, 0), ("b3", 50, 50, 0), ("g3", 51, 54, 0),
     ("b1", 55, 60, 0), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 69, 0), ("b3", 70, 70, 2), ("r3", 71, 75, 0),
     ("b3", 76, 76, 3)],
    # mode 9 (:392-422)
    [("r0", 5, 10, 0), ("g3", 11, 11, 4), ("b3", 12, 13, 0),
     ("b2", 14, 14, 4), ("g0", 15, 20, 0), ("g2", 21, 21, 5),
     ("b2", 22, 22, 5), ("b3", 23, 23, 2), ("g2", 24, 24, 4),
     ("b0", 25, 30, 0), ("g3", 31, 31, 5), ("b3", 32, 32, 3),
     ("b3", 33, 33, 5), ("b3", 34, 34, 4), ("r1", 35, 40, 0),
     ("g2", 41, 44, 0), ("g1", 45, 50, 0), ("g3", 51, 54, 0),
     ("b1", 55, 60, 0), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 70, 0), ("r3", 71, 76, 0)],
    # mode 10 (:423-435)
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 44, 0), ("g1", 45, 54, 0), ("b1", 55, 63, 0),
     ("b1", 64, 64, 9)],
    # mode 11 (:436-450)
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 43, 0), ("r0", 44, 44, 10), ("g1", 45, 53, 0),
     ("g0", 54, 54, 10), ("b1", 55, 63, 0), ("b0", 64, 64, 10)],
    # mode 12 (:451-467) — reversed 2-bit fields.
    # NOTE: the reference's `detexGetBits64(data0, 63, 63) << 11`
    # (decompress-bptc-float.c:462) hits C UB (`1 << 64` in the mask,
    # bits.h:31); the compiled oracle folds it to 0, so b0[11] is
    # always zero.  Verified empirically against the compiled
    # reference; we mirror that behavior, so the field is omitted.
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 42, 0), ("r0", 43, 44, 10, True), ("g1", 45, 52, 0),
     ("g0", 53, 54, 10, True), ("b1", 55, 62, 0),
     ("b0", 64, 64, 10)],
    # mode 13 (:468-484) — reversed 5/6-bit fields
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 38, 0), ("r0", 39, 44, 10, True), ("g1", 45, 48, 0),
     ("g0", 49, 54, 10, True), ("b1", 55, 58, 0),
     ("b0", 59, 63, 11, True), ("b0", 64, 64, 10)],
]

# Anchored index-stream offsets, like ops.bptc: NS=2 modes (0-9) start
# at bit 82 with 3-bit indices; NS=1 modes (10-13) start at 65 with
# 4-bit indices (decompress-bptc-float.c:543-551).
_IS_ANCHOR_2 = np.zeros((64, 16), dtype=bool)
_IS_ANCHOR_2[:, 0] = True
_IS_ANCHOR_2[np.arange(64), _ANCHOR2] = True
_BEFORE_2 = (np.cumsum(_IS_ANCHOR_2, axis=1) - _IS_ANCHOR_2).astype(np.int32)
_OFF_2 = (3 * np.arange(16)[None, :] - _BEFORE_2 + 82).astype(np.int32)
_MASK_2 = np.where(_IS_ANCHOR_2, 3, 7).astype(np.int32)
_OFF_1 = np.array([65 + 4 * i - (1 if i > 0 else 0) for i in range(16)],
                  np.int32)
_MASK_1 = np.array([7] + [15] * 15, np.int32)


def _rev_field(words, lo: int, hi: int):
    """Reversed bitfield: memory bit `hi` -> LSB (bits.h:34-47 called
    with bit0=hi, bit1=lo)."""
    out = None
    width = hi - lo + 1
    for i in range(width):
        bit = field_words(words, hi - i, 1) << i
        out = bit if out is None else jnp.bitwise_or(out, bit)
    return out


def _sign_extend(v, bits: int):
    half = 1 << (bits - 1)
    return (jnp.bitwise_and(v, (1 << bits) - 1) ^ half) - half


def _unquantize(x, mode: int):
    """Unsigned unquantize (decompress-bptc-float.c:52-63)."""
    epb = _EPB[mode]
    if mode == 13:
        return x
    unq = ((x << 15) + 0x4000) >> (epb - 1)
    unq = jnp.where(x == 0, 0, jnp.where(x == (1 << epb) - 1, 0xFFFF, unq))
    return unq


def _unquantize_signed(x, mode: int):
    """Signed unquantize (decompress-bptc-float.c:65-86)."""
    epb = _EPB[mode]
    if epb >= 16:
        return x
    mag = jnp.abs(x)
    unq = ((mag << 15) + 0x4000) >> (epb - 1)
    unq = jnp.where(mag == 0, 0,
                    jnp.where(mag >= (1 << (epb - 1)) - 1, 0x7FFF, unq))
    return jnp.sign(x) * unq


def _decode_mode(words, mode: int, signed: bool):
    """Decode every block under one BC6H mode; (N, 16, 3) int32 u16."""
    n = words.shape[0]
    epb = _EPB[mode]
    ep = {k: jnp.zeros((n,), jnp.int32)
          for k in ("r0", "r1", "r2", "r3", "g0", "g1", "g2", "g3",
                    "b0", "b1", "b2", "b3")}
    for f in _FIELDS[mode]:
        dest, lo, hi, shift = f[0], f[1], f[2], f[3]
        rev = len(f) > 4 and f[4]
        val = _rev_field(words, lo, hi) if rev \
            else field_words(words, lo, hi - lo + 1)
        ep[dest] = jnp.bitwise_or(ep[dest], val << shift)

    ns = 1 if mode >= 10 else 2
    chans = {}
    for c in "rgb":
        e = [ep[f"{c}{i}"] for i in range(4)]
        if signed:
            e[0] = _sign_extend(e[0], epb)
        if _DELTA[mode] is not None:
            db = _DELTA[mode]["rgb".index(c)]
            for i in range(1, ns * 2):
                d = _sign_extend(e[i], db)
                e[i] = jnp.bitwise_and(e[0] + d, (1 << epb) - 1)
                if signed:
                    e[i] = _sign_extend(e[i], epb)
        elif signed:
            for i in range(1, ns * 2):
                e[i] = _sign_extend(e[i], epb)
        if signed:
            e = [_unquantize_signed(v, mode) for v in e]
        else:
            e = [_unquantize(v, mode) for v in e]
        chans[c] = e

    if ns == 2:
        psid = field_words(words, 77, 5)
        subset = jnp.asarray(_P2)[psid]
        off = jnp.asarray(_OFF_2)[psid]
        mask = jnp.asarray(_MASK_2)[psid]
        ib = 3
    else:
        subset = jnp.zeros((n, 16), jnp.int32)
        off = jnp.broadcast_to(jnp.asarray(_OFF_1)[None, :], (n, 16))
        mask = jnp.asarray(_MASK_1)[None, :]
        ib = 4
    idx = jnp.bitwise_and(dyn_field(words, off, ib), mask)
    w = jnp.asarray(_WEIGHTS[ib])[idx]

    out = []
    for c in "rgb":
        e0 = chans[c][0][:, None]
        e1 = chans[c][1][:, None]
        if ns == 2:
            e0 = jnp.where(subset == 1, chans[c][2][:, None], e0)
            e1 = jnp.where(subset == 1, chans[c][3][:, None], e1)
        v = ((64 - w) * e0 + w * e1 + 32) >> 6
        if signed:
            # *31 >> 5 on the magnitude, then sign-magnitude assembly.
            # The sign bit applies only if the *scaled* value is still
            # negative: a tiny negative interpolant scales to -0 and
            # stays +0 (decompress-bptc-float.c:576-612).
            scaled = jnp.where(v < 0, -((-v * 31) >> 5), (v * 31) >> 5)
            v = jnp.where(scaled < 0, jnp.bitwise_or(-scaled, 0x8000),
                          scaled)
        else:
            v = (v * 31) // 64
        out.append(v)
    return jnp.stack(out, axis=-1)


def _extract_mode(words):
    m2 = field(words[:, 0], 0, 2)
    code5 = field(words[:, 0], 0, 5)
    return jnp.where(m2 < 2, m2, jnp.asarray(_MAP_MODE)[code5])


def _decode_shared(words, mode_mask: int, flags: int, signed: bool):
    mode = _extract_mode(words)
    rgb = _decode_mode(words, 0, signed)
    for m in range(1, 14):
        rgb = jnp.where((mode == m)[:, None, None],
                        _decode_mode(words, m, signed), rgb)
    n = words.shape[0]
    pix = jnp.concatenate(
        [rgb, jnp.zeros((n, 16, 1), jnp.int32)], axis=-1)
    valid = (mode >= 0) & mask_bit(mode_mask, mode)
    return pix, valid


def decode_bptc_float(words, mode_mask: int = _FULL, flags: int = 0):
    """BC6H unsigned (reference detexDecompressBlockBPTC_FLOAT,
    decompress-bptc-float.c:631-635).  words: (N, 4) int32."""
    return _decode_shared(words, mode_mask, flags, False)


def decode_bptc_signed_float(words, mode_mask: int = _FULL, flags: int = 0):
    """BC6H signed (reference detexDecompressBlockBPTC_SIGNED_FLOAT,
    decompress-bptc-float.c:640-644).  words: (N, 4) int32."""
    return _decode_shared(words, mode_mask, flags, True)
