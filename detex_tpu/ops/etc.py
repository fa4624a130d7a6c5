"""ETC1 / ETC2 / ETC2_PUNCHTHROUGH block decoders — batched, branch-free.

Batched redesign of the reference per-block decoders
(reference: decompress-etc.c:72-717).  The reference picks one of five
code paths per block (individual, differential, T, H, planar); here all
candidate palettes are computed for the whole batch with vector ops and
the final pixel is selected per block by the detected mode — no
data-dependent control flow, which keeps the whole decode jittable and
vector-friendly.

Bit-exact semantics reproduced:
  * modifier table and 3-bit two's-complement deltas with bit
    replication (decompress-etc.c:25-34, 102-138)
  * differential-mode overflow check `base & 0xFF07` -> invalid block
    (decompress-etc.c:111-122); also the ETC2 mode-detection trick:
    R/G/B overflow selects T/H/planar (decompress-etc.c:331-362)
  * T/H paint colors with the etc2 distance table
    (decompress-etc.c:200-285), H tie-break bit from base color
    magnitudes (decompress-etc.c:253-260)
  * planar 6-7-6 bilinear `(x*(CH-CO) + y*(CV-CO) + 4*CO + 2) >> 2`
    (decompress-etc.c:287-317)
  * punchthrough modifier/mask tables: pixel index 2 -> transparent
    black (decompress-etc.c:472-500)
  * column-major pixel transpose out[(i&3)*4 + (i>>2)]
    (decompress-etc.c:83, 283, 315)

All decoders take (N, 2) little-endian int32 words and return
((N, 16) int32 packed RGBA8, (N,) bool valid).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from detex_tpu import formats as F
from detex_tpu.ops.bitops import field, has_flag, mask_bit, pack_rgba8, shr
from detex_tpu.ops.eac import bswap32, decode_eac_alpha

_FULL = 0xFFFFFFFF

# decompress-etc.c:25-34
ETC_MODIFIER_TABLE = np.array([
    [2, 8, -2, -8],
    [5, 17, -5, -17],
    [9, 29, -9, -29],
    [13, 42, -13, -42],
    [18, 60, -18, -60],
    [24, 80, -24, -80],
    [33, 106, -33, -106],
    [47, 183, -47, -183],
], dtype=np.int32)

# decompress-etc.c:472-481
PUNCHTHROUGH_MODIFIER_TABLE = np.array([
    [0, 8, 0, -8],
    [0, 17, 0, -17],
    [0, 29, 0, -29],
    [0, 42, 0, -42],
    [0, 60, 0, -60],
    [0, 80, 0, -80],
    [0, 106, 0, -106],
    [0, 183, 0, -183],
], dtype=np.int32)

# decompress-etc.c:200
ETC2_DISTANCE_TABLE = np.array([3, 6, 11, 16, 23, 32, 41, 64], dtype=np.int32)

# Output pixel j <- reference loop variable i = (j&3)*4 + (j>>2)
# (the column-major transpose is an involution).
_J = np.arange(16)
_SRC_I = ((_J & 3) * 4 + (_J >> 2)).astype(np.int32)
_OUT_X = (_J & 3).astype(np.int32)   # output column
_OUT_Y = (_J >> 2).astype(np.int32)  # output row


def _byte(w0, k: int):
    return field(w0, 8 * k, 8)


def _pixel_indices(w1):
    """(N,) word of bytes 4-7 -> (N, 16) 2-bit pixel indices in output
    pixel order (decompress-etc.c:75-76, 278-279)."""
    piw = bswap32(w1)
    i = jnp.asarray(_SRC_I)
    lsb = jnp.bitwise_and(shr(piw[:, None], i[None, :]), 1)
    msb = jnp.bitwise_and(shr(piw[:, None], (16 + i)[None, :]), 1)
    return jnp.bitwise_or(lsb, msb << 1)


def _complement3shifted(x):
    """3-bit two's complement, shifted left 3 (decompress-etc.c:54-62)."""
    return jnp.where(x >= 4, (x - 8) << 3, x << 3)


def _replicate5(v):
    """5-bit-in-high-bits value -> 8 bits: v | ((v & 224) >> 5)."""
    return jnp.bitwise_or(v, shr(jnp.bitwise_and(v, 224), 5))


def _replicate4(lo4):
    """4-bit value -> 8 bits: v | v << 4."""
    return jnp.bitwise_or(lo4, lo4 << 4)


def _etc1_candidates(b0, b1, b2):
    """Individual + differential base colors for both subblocks.

    Returns (ind1, ind2, diff1, diff2, diff_ok) where each entry is a
    3-tuple of (N,) int32 RGB and diff_ok flags the no-overflow case
    (decompress-etc.c:102-138)."""
    ind1 = tuple(jnp.bitwise_or(jnp.bitwise_and(b, 0xF0),
                                shr(jnp.bitwise_and(b, 0xF0), 4))
                 for b in (b0, b1, b2))
    ind2 = tuple(_replicate4(jnp.bitwise_and(b, 0x0F)) for b in (b0, b1, b2))
    base1 = tuple(_replicate5(jnp.bitwise_and(b, 0xF8)) for b in (b0, b1, b2))
    raw2 = tuple(jnp.bitwise_and(b, 0xF8)
                 + _complement3shifted(jnp.bitwise_and(b, 7))
                 for b in (b0, b1, b2))
    overflow = tuple(jnp.bitwise_and(r, 0xFF07) != 0 for r in raw2)
    diff_ok = ~(overflow[0] | overflow[1] | overflow[2])
    base2 = tuple(_replicate5(r) for r in raw2)
    return ind1, ind2, base1, base2, overflow


def _etc1_pixels(w0, w1, sub1, sub2, table):
    """Assemble per-pixel RGB for an ETC1-style block given the two
    subblock base colors; returns (r, g, b) each (N, 16) plus the
    per-pixel index (for punchthrough masking)."""
    b3 = _byte(w0, 3)
    flip = jnp.bitwise_and(b3, 1)
    cw1 = shr(jnp.bitwise_and(b3, 224), 5)
    cw2 = shr(jnp.bitwise_and(b3, 28), 2)
    pidx = _pixel_indices(w1)
    # flip == 0: columns 2-3 use subblock 2; flip == 1: rows 2-3.
    use2 = jnp.where(flip[:, None] == 0,
                     jnp.asarray(_OUT_X >= 2)[None, :],
                     jnp.asarray(_OUT_Y >= 2)[None, :])
    codeword = jnp.where(use2, cw2[:, None], cw1[:, None])
    tab = jnp.asarray(table)
    modifier = tab[codeword, pidx]
    out = []
    for c in range(3):
        base = jnp.where(use2, sub2[c][:, None], sub1[c][:, None])
        out.append(jnp.clip(base + modifier, 0, 255))
    return out[0], out[1], out[2], pidx


def _th_paint_colors(b0, b1, b2, b3):
    """Paint colors for T and H modes (decompress-etc.c:202-273).
    Returns (t_rgb, h_rgb): each a list of 4 (r, g, b) tuples."""
    # T mode base colors
    t1r = _replicate4(jnp.bitwise_or(shr(jnp.bitwise_and(b0, 0x18), 1),
                                     jnp.bitwise_and(b0, 0x3)))
    t1g = jnp.bitwise_and(b1, 0xF0)
    t1g = jnp.bitwise_or(t1g, shr(t1g, 4))
    t1b = _replicate4(jnp.bitwise_and(b1, 0x0F))
    t2r = jnp.bitwise_and(b2, 0xF0)
    t2r = jnp.bitwise_or(t2r, shr(t2r, 4))
    t2g = _replicate4(jnp.bitwise_and(b2, 0x0F))
    t2b = jnp.bitwise_and(b3, 0xF0)
    t2b = jnp.bitwise_or(t2b, shr(t2b, 4))
    dist_t = jnp.asarray(ETC2_DISTANCE_TABLE)[
        jnp.bitwise_or(shr(jnp.bitwise_and(b3, 0x0C), 1),
                       jnp.bitwise_and(b3, 0x1))]
    c = jnp.clip
    t_paint = [
        (t1r, t1g, t1b),
        (c(t2r + dist_t, 0, 255), c(t2g + dist_t, 0, 255),
         c(t2b + dist_t, 0, 255)),
        (t2r, t2g, t2b),
        (c(t2r - dist_t, 0, 255), c(t2g - dist_t, 0, 255),
         c(t2b - dist_t, 0, 255)),
    ]
    # H mode base colors
    h1r = _replicate4(shr(jnp.bitwise_and(b0, 0x78), 3))
    h1g = _replicate4(jnp.bitwise_or(jnp.bitwise_and(b0, 0x07) << 1,
                                     shr(jnp.bitwise_and(b1, 0x10), 4)))
    h1b = _replicate4(jnp.bitwise_and(b1, 0x08)
                      | (jnp.bitwise_and(b1, 0x03) << 1)
                      | shr(jnp.bitwise_and(b2, 0x80), 7))
    h2r = _replicate4(shr(jnp.bitwise_and(b2, 0x78), 3))
    h2g = _replicate4(jnp.bitwise_or(jnp.bitwise_and(b2, 0x07) << 1,
                                     shr(jnp.bitwise_and(b3, 0x80), 7)))
    h2b = _replicate4(shr(jnp.bitwise_and(b3, 0x78), 3))
    v1 = (h1r << 16) + (h1g << 8) + h1b
    v2 = (h2r << 16) + (h2g << 8) + h2b
    tie = (v1 >= v2).astype(jnp.int32)
    dist_h = jnp.asarray(ETC2_DISTANCE_TABLE)[
        jnp.bitwise_and(b3, 0x04) | (jnp.bitwise_and(b3, 0x01) << 1) | tie]
    h_paint = [
        (c(h1r + dist_h, 0, 255), c(h1g + dist_h, 0, 255),
         c(h1b + dist_h, 0, 255)),
        (c(h1r - dist_h, 0, 255), c(h1g - dist_h, 0, 255),
         c(h1b - dist_h, 0, 255)),
        (c(h2r + dist_h, 0, 255), c(h2g + dist_h, 0, 255),
         c(h2b + dist_h, 0, 255)),
        (c(h2r - dist_h, 0, 255), c(h2g - dist_h, 0, 255),
         c(h2b - dist_h, 0, 255)),
    ]
    return t_paint, h_paint


def _paint_select(paint, pidx):
    """Select per-pixel RGB from a 4-entry paint palette by (N,16) index."""
    out = []
    for c in range(3):
        chans = [p[c][:, None] for p in paint]
        out.append(jnp.where(pidx == 0, chans[0],
                             jnp.where(pidx == 1, chans[1],
                                       jnp.where(pidx == 2, chans[2],
                                                 chans[3]))))
    return out


def _planar_pixels(b_list):
    """Planar-mode bilinear pixels (decompress-etc.c:287-317)."""
    b0, b1, b2, b3, b4, b5, b6, b7 = b_list
    ro = shr(jnp.bitwise_and(b0, 0x7E), 1)
    go = jnp.bitwise_or(jnp.bitwise_and(b0, 0x1) << 6,
                        shr(jnp.bitwise_and(b1, 0x7E), 1))
    bo = ((jnp.bitwise_and(b1, 0x1) << 5) | jnp.bitwise_and(b2, 0x18)
          | (jnp.bitwise_and(b2, 0x03) << 1) | shr(jnp.bitwise_and(b3, 0x80),
                                                   7))
    rh = jnp.bitwise_or(shr(jnp.bitwise_and(b3, 0x7C), 1),
                        jnp.bitwise_and(b3, 0x1))
    gh = shr(jnp.bitwise_and(b4, 0xFE), 1)
    bh = jnp.bitwise_or(jnp.bitwise_and(b4, 0x1) << 5,
                        shr(jnp.bitwise_and(b5, 0xF8), 3))
    rv = jnp.bitwise_or(jnp.bitwise_and(b5, 0x7) << 3,
                        shr(jnp.bitwise_and(b6, 0xE0), 5))
    gv = jnp.bitwise_or(jnp.bitwise_and(b6, 0x1F) << 2,
                        shr(jnp.bitwise_and(b7, 0xC0), 6))
    bv = jnp.bitwise_and(b7, 0x3F)

    def rep676(v, green):
        if green:
            return (v << 1) | shr(jnp.bitwise_and(v, 0x40), 6)
        return (v << 2) | shr(jnp.bitwise_and(v, 0x30), 4)

    ro, rh, rv = rep676(ro, False), rep676(rh, False), rep676(rv, False)
    go, gh, gv = rep676(go, True), rep676(gh, True), rep676(gv, True)
    bo, bh, bv = rep676(bo, False), rep676(bh, False), rep676(bv, False)
    x = jnp.asarray(_OUT_X)[None, :]
    y = jnp.asarray(_OUT_Y)[None, :]

    def plane(o, h, v):
        # Arithmetic >> 2: the bilinear sum can be negative before the
        # clamp (decompress-etc.c:312-314 shifts a signed int).
        return jnp.clip((x * (h[:, None] - o[:, None])
                         + y * (v[:, None] - o[:, None])
                         + 4 * o[:, None] + 2) >> 2, 0, 255)

    return plane(ro, rh, rv), plane(go, gh, gv), plane(bo, bh, bv)


def _alpha_ff(shape):
    return jnp.full(shape, 0xFF, jnp.int32)


def decode_etc1(words, mode_mask: int = _FULL, flags: int = 0):
    """ETC1 (reference detexDecompressBlockETC1, decompress-etc.c:89-180)."""
    w0, w1 = words[:, 0], words[:, 1]
    b0, b1, b2 = _byte(w0, 0), _byte(w0, 1), _byte(w0, 2)
    differential = jnp.bitwise_and(_byte(w0, 3), 2) != 0
    ind1, ind2, dif1, dif2, overflow = _etc1_candidates(b0, b1, b2)
    diff_ok = ~(overflow[0] | overflow[1] | overflow[2])
    ri, gi, bi, _ = _etc1_pixels(w0, w1, ind1, ind2, ETC_MODIFIER_TABLE)
    rd, gd, bd, _ = _etc1_pixels(w0, w1, dif1, dif2, ETC_MODIFIER_TABLE)
    dm = differential[:, None]
    r = jnp.where(dm, rd, ri)
    g = jnp.where(dm, gd, gi)
    b = jnp.where(dm, bd, bi)
    pix = pack_rgba8(r, g, b, _alpha_ff(r.shape))
    valid = jnp.where(differential, diff_ok, True)
    valid = valid & ~(~has_flag(mode_mask, F.MODE_MASK_ETC_DIFFERENTIAL)
                     & differential)
    valid = valid & ~(~has_flag(mode_mask, F.MODE_MASK_ETC_INDIVIDUAL)
                      & ~differential)
    return pix, valid


def _etc2_modes(b0, b1, b2, w0):
    """Per-block ETC2 mode: 0=individual, 1=differential, 2=T, 3=H,
    4=planar (decompress-etc.c:321-367 dispatch logic)."""
    differential = jnp.bitwise_and(_byte(w0, 3), 2) != 0
    _, _, _, _, overflow = _etc1_candidates(b0, b1, b2)
    mode = jnp.where(~differential, 0,
                     jnp.where(overflow[0], 2,
                               jnp.where(overflow[1], 3,
                                         jnp.where(overflow[2], 4, 1))))
    return mode


def _etc2_all_pixels(w0, w1, punchthrough_nonopaque=None):
    """All candidate pixel sets for an ETC2-family block.

    Returns (mode (N,), pix_by_mode list of 5 (N,16) packed RGBA8).
    If punchthrough_nonopaque is a (N,) bool, non-opaque blocks use the
    punchthrough tables/masks for differential/T/H paths."""
    b0, b1, b2 = _byte(w0, 0), _byte(w0, 1), _byte(w0, 2)
    b3 = _byte(w0, 3)
    mode = _etc2_modes(b0, b1, b2, w0)
    ind1, ind2, dif1, dif2, _ = _etc1_candidates(b0, b1, b2)
    t_paint, h_paint = _th_paint_colors(b0, b1, b2, b3)
    pidx_th = _pixel_indices(w1)

    ri, gi, bi, _ = _etc1_pixels(w0, w1, ind1, ind2, ETC_MODIFIER_TABLE)
    pix_ind = pack_rgba8(ri, gi, bi, _alpha_ff(ri.shape))

    rd, gd, bd, pidx_d = _etc1_pixels(w0, w1, dif1, dif2, ETC_MODIFIER_TABLE)
    pix_diff = pack_rgba8(rd, gd, bd, _alpha_ff(rd.shape))

    rt, gt, bt = _paint_select(t_paint, pidx_th)
    pix_t = pack_rgba8(rt, gt, bt, _alpha_ff(rt.shape))
    rh, gh, bh = _paint_select(h_paint, pidx_th)
    pix_h = pack_rgba8(rh, gh, bh, _alpha_ff(rh.shape))

    rp, gp, bp = _planar_pixels([b0, b1, b2, b3, _byte(w1, 0), _byte(w1, 1),
                                 _byte(w1, 2), _byte(w1, 3)])
    pix_planar = pack_rgba8(rp, gp, bp, _alpha_ff(rp.shape))

    if punchthrough_nonopaque is not None:
        np_mask = punchthrough_nonopaque[:, None]
        # Differential with punchthrough table + transparent index 2
        # (decompress-etc.c:503-563): no overflow check, masks index 2.
        rpd, gpd, bpd, pidx_pd = _etc1_pixels(
            w0, w1, dif1, dif2, PUNCHTHROUGH_MODIFIER_TABLE)
        keep_d = pidx_pd != 2
        pix_pt_diff = jnp.where(
            keep_d, pack_rgba8(rpd, gpd, bpd, _alpha_ff(rpd.shape)), 0)
        pix_diff = jnp.where(np_mask, pix_pt_diff, pix_diff)
        # T/H with transparency mask (decompress-etc.c:565-649): same
        # paint colors, index 2 -> transparent black.
        keep_th = pidx_th != 2
        pix_t = jnp.where(np_mask, jnp.where(keep_th, pix_t, 0), pix_t)
        pix_h = jnp.where(np_mask, jnp.where(keep_th, pix_h, 0), pix_h)
    return mode, [pix_ind, pix_diff, pix_t, pix_h, pix_planar]


def _select_by_mode(mode, pix_by_mode):
    m = mode[:, None]
    out = pix_by_mode[0]
    for k in range(1, 5):
        out = jnp.where(m == k, pix_by_mode[k], out)
    return out


def _mode_mask_valid(mode, mode_mask):
    """Per-block validity from the runtime mode_mask
    (decompress-etc.c:92-98, 329-366).  The ETC mode-mask bit for
    per-block mode k is simply bit k (MODE_MASK_ETC_* are 1<<k)."""
    return mask_bit(mode_mask, mode)


def decode_etc2(words, mode_mask: int = _FULL, flags: int = 0):
    """ETC2 (reference detexDecompressBlockETC2, decompress-etc.c:321-367)."""
    w0, w1 = words[:, 0], words[:, 1]
    mode, pix_by_mode = _etc2_all_pixels(w0, w1)
    pix = _select_by_mode(mode, pix_by_mode)
    valid = _mode_mask_valid(mode, mode_mask)
    return pix, valid


def decode_etc2_punchthrough(words, mode_mask: int = _FULL, flags: int = 0):
    """ETC2_PUNCHTHROUGH (reference detexDecompressBlockETC2_PUNCHTHROUGH,
    decompress-etc.c:653-717)."""
    w0, w1 = words[:, 0], words[:, 1]
    opaque = jnp.bitwise_and(_byte(w0, 3), 2) != 0
    mode, pix_by_mode = _etc2_all_pixels(
        w0, w1, punchthrough_nonopaque=~opaque)
    # The differential bit is the opaque bit here; every block decodes
    # through the differential/T/H/planar paths (mode >= 1 semantics:
    # mode detection ignores the opaque bit, individual never occurs).
    b0, b1, b2 = _byte(w0, 0), _byte(w0, 1), _byte(w0, 2)
    _, _, _, _, overflow = _etc1_candidates(b0, b1, b2)
    mode_pt = jnp.where(overflow[0], 2,
                        jnp.where(overflow[1], 3,
                                  jnp.where(overflow[2], 4, 1)))
    pix = _select_by_mode(mode_pt, pix_by_mode)
    valid = _mode_mask_valid(mode_pt, mode_mask)
    non_op = has_flag(flags, F.FLAG_NON_OPAQUE_ONLY)
    # Planar is always opaque (decompress-etc.c:700-702).
    valid = valid & ~(non_op & (opaque | (mode_pt == 4)))
    valid = valid & ~(has_flag(flags, F.FLAG_OPAQUE_ONLY) & ~opaque)
    return pix, valid


def decode_etc2_eac(words, mode_mask: int = _FULL, flags: int = 0):
    """ETC2_EAC: ETC2 color from bytes 8-15 + EAC alpha from bytes 0-7
    (reference detexDecompressBlockETC2_EAC, decompress-eac.c:54-86).
    words: (N, 4) int32."""
    color_pix, color_valid = decode_etc2(words[:, 2:4], mode_mask, flags)
    alpha, alpha_valid = decode_eac_alpha(words[:, 0], words[:, 1], flags)
    pix = jnp.bitwise_or(jnp.bitwise_and(color_pix, 0x00FFFFFF), alpha << 24)
    return pix, color_valid & alpha_valid
