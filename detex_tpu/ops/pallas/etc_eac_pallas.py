"""ETC2 / ETC2_PUNCHTHROUGH / ETC2_EAC decoders as fused Pallas kernels,
compiled for the GPU through Triton (ops/pallas.planar_call).

Bit-exact re-implementations of the jnp decoders in ops.etc / ops.eac
(reference: decompress-etc.c:72-717, decompress-eac.c:44-231) as one
pass per block: words (k, N) int32 in, packed RGBA8 pixels (16, N) out.

The table lookups exploit table structure instead of gathers:

  * ETC modifier table rows are [a, b, -a, -b]
    (decompress-etc.c:25-34): one 8-entry select tree per column per
    subblock, then sign/column arithmetic per pixel.  The punchthrough
    table (decompress-etc.c:472-481) is the same with a == 0.
  * EAC modifier table columns 4..7 equal -(columns 0..3) - 1
    (decompress-eac.c:21-38): ONE 16-entry select tree per block over
    the packed 4x5-bit row + a per-pixel variable-field shift.
  * ETC2 distance table (decompress-etc.c:200): one 8-entry tree each
    for the T and H distances.

The ETC color path runs on packed 10-bit RGB lanes (R|G<<10|B<<20,
+256 bias): per-block packed bases/paint + one packed select and one
SWAR saturating clamp per pixel instead of three per-channel select
cascades — see the "ETC2 SWAR core" section.

Entry points: decode_<family>_planar ((k, N) words) and decode_<family>
((N, k) rows, the engine decoder table's layout).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from detex_tpu.ops import eac as EACJ
from detex_tpu.ops import etc as ETCJ
from detex_tpu.ops.pallas import planar_call

_FULL = 0xFFFFFFFF

# Table structure checks (see module docstring).
_ETC_A = ETCJ.ETC_MODIFIER_TABLE[:, 0]
_ETC_B = ETCJ.ETC_MODIFIER_TABLE[:, 1]
assert np.array_equal(ETCJ.ETC_MODIFIER_TABLE[:, 2], -_ETC_A)
assert np.array_equal(ETCJ.ETC_MODIFIER_TABLE[:, 3], -_ETC_B)
assert np.array_equal(ETCJ.PUNCHTHROUGH_MODIFIER_TABLE[:, 0], 0 * _ETC_A)
assert np.array_equal(ETCJ.PUNCHTHROUGH_MODIFIER_TABLE[:, 1], _ETC_B)
assert np.array_equal(ETCJ.PUNCHTHROUGH_MODIFIER_TABLE[:, 2], 0 * _ETC_A)
assert np.array_equal(ETCJ.PUNCHTHROUGH_MODIFIER_TABLE[:, 3], -_ETC_B)
_EAC_M = EACJ.EAC_MODIFIER_TABLE
assert np.array_equal(_EAC_M[:, 4:], -_EAC_M[:, :4] - 1)
# The four per-row magnitudes packed as 5-bit biased fields: ONE
# 16-entry select tree per block instead of four.
assert int(_EAC_M[:, :4].min()) >= -16 and int(_EAC_M[:, :4].max()) < 16
_EAC_MP = np.zeros(16, np.int32)
for _c in range(4):
    _EAC_MP |= ((np.asarray(_EAC_M[:, _c], np.int64) + 16)
                << (5 * _c)).astype(np.int32)

_DIST = ETCJ.ETC2_DISTANCE_TABLE
# (a, b) modifier pair packed per codeword row (a <= 47 -> 6 bits):
# one 8-entry tree per subblock instead of two.
assert int(_ETC_A.min()) >= 0 and int(_ETC_A.max()) < 64
assert int(_ETC_B.min()) >= 0 and int(_ETC_B.max()) < 256
_ETC_AB = (np.asarray(_ETC_A, np.int64)
           | (np.asarray(_ETC_B, np.int64) << 6)).astype(np.int32)
_OUT_X = ETCJ._OUT_X
_OUT_Y = ETCJ._OUT_Y
_SRC_I = ETCJ._SRC_I


def _shr(x, n):
    return lax.shift_right_logical(x, n)


def _shl(x, n):
    return lax.shift_left(x, n)


def _sel_tree(tab, bits):
    """Select-tree gather from a small numpy table by index bit vectors
    (len(tab) must be a power of two; len(bits) levels)."""
    cur = [int(v) for v in tab]
    for b in bits:
        cur = [jnp.where(b, hi, lo) for lo, hi in zip(cur[0::2], cur[1::2])]
    assert len(cur) == 1
    return cur[0]


def _bits_of(idx, n):
    return [(idx & (1 << i)) != 0 for i in range(n)]


def _bswap32(w):
    return ((_shr(w, 24) & 0xFF) | (_shr(w, 8) & 0xFF00)
            | _shl(w & 0xFF00, 8) | _shl(w, 24))


def _byte(w, k: int):
    return _shr(w, 8 * k) & 0xFF


def _rep4(v):
    return v | _shl(v, 4)


def _rep5hi(v):
    """5 bits already in [7:3] -> 8 bits."""
    return v | _shr(v & 224, 5)


def _clamp255(v):
    return jnp.clip(v, 0, 255)


# ---------------------------------------------------------------------------
# ETC SWAR core: packed 10-bit RGB lanes (VERDICT r3 #2)
# ---------------------------------------------------------------------------
# The per-pixel critical path of the straight ETC2 kernel is a cascade
# of ~29 cmpsel ops (3 channels x {base select, clamp, T/H paint
# select, planar merge}).  This variant packs R|G<<10|B<<20 with a
# +256 per-lane bias per BLOCK (bases, merged T/H paint) so the pixel
# loop does ONE packed select + ONE SWAR saturating clamp instead of
# three channel cascades: ~13 cmpsel per pixel.  Bit-exactness is
# pinned by the same goldens/fuzz as the straight kernel.

_LANE3 = 0x00100401            # lane bases: bits 0, 10, 20
_BIAS3 = 256 * _LANE3


def _pack3(r, g, b):
    return r | _shl(g, 10) | _shl(b, 20)


def _swar_clamp_biased(v):
    """Per-lane clamp of biased 10-bit lanes to [256, 511] (= [0, 255]
    unbiased).  Input lanes must be in [0, 1023].  The per-lane fill
    masks are built with shift-subtract (hi*0x1FF == hi<<9 - hi) —
    int32 multiply is the expensive integer operation."""
    ones = _LANE3
    hi = _shr(v, 9) & ones                   # lane >= 512
    v = (v | (_shl(hi, 9) - hi)) - _shl(hi, 9)   # -> 511 in those lanes
    u = _shr(v, 8) & ones                    # lane >= 256
    return (v & (_shl(u, 10) - u)) | _shl(u ^ ones, 8)   # < 256 -> 256


def _swar_to_rgba(v, alpha):
    """Biased SWAR lanes (each in [256, 511]) -> packed RGBA8."""
    v = v - _BIAS3
    return (v & 0xFF) | (_shr(v, 2) & 0xFF00) | (_shr(v, 4) & 0xFF0000) \
        | _shl(alpha, 24)


def _etc2_pixels_swar(w0, w1, *, punchthrough: bool = False):
    """ETC pixel decode with packed-lane per-pixel work.  Returns
    (mode, rgb_swar 16-list of biased-lane words CLAMPED, keep 16-list
    or None)."""
    b0, b1, b2, b3 = (_byte(w0, k) for k in range(4))

    ind1 = tuple(v | _shr(v, 4) for v in ((b0 & 0xF0), (b1 & 0xF0),
                                          (b2 & 0xF0)))
    ind2 = tuple(_rep4(b & 0x0F) for b in (b0, b1, b2))
    base1 = tuple(_rep5hi(b & 0xF8) for b in (b0, b1, b2))
    d3 = tuple(b & 7 for b in (b0, b1, b2))
    raw2 = tuple((b & 0xF8) + jnp.where(d >= 4, _shl(d - 8, 3), _shl(d, 3))
                 for b, d in zip((b0, b1, b2), d3))
    overflow = tuple((r & 0xFF07) != 0 for r in raw2)
    base2 = tuple(_rep5hi(r) for r in raw2)

    differential = (b3 & 2) != 0
    if punchthrough:
        mode = jnp.where(overflow[0], 2,
                         jnp.where(overflow[1], 3,
                                   jnp.where(overflow[2], 4, 1)))
    else:
        mode = jnp.where(~differential, 0,
                         jnp.where(overflow[0], 2,
                                   jnp.where(overflow[1], 3,
                                             jnp.where(overflow[2], 4, 1))))

    flip = b3 & 1
    cw1_bits = _bits_of(_shr(b3 & 224, 5), 3)
    cw2_bits = _bits_of(_shr(b3 & 28, 2), 3)
    ab1 = _sel_tree(_ETC_AB, cw1_bits)
    ab2 = _sel_tree(_ETC_AB, cw2_bits)
    a1, b1m = ab1 & 63, _shr(ab1, 6)
    a2, b2m = ab2 & 63, _shr(ab2, 6)

    piw = _bswap32(w1)

    # T/H paint colors, packed per block (channel math identical to
    # the straight kernel; decompress-etc.c:202-273).
    t1r = _rep4(_shr(b0 & 0x18, 1) | (b0 & 0x3))
    t1g = (b1 & 0xF0) | _shr(b1 & 0xF0, 4)
    t1b = _rep4(b1 & 0x0F)
    t2r = (b2 & 0xF0) | _shr(b2 & 0xF0, 4)
    t2g = _rep4(b2 & 0x0F)
    t2b = (b3 & 0xF0) | _shr(b3 & 0xF0, 4)
    dist_t = _sel_tree(_DIST, _bits_of(_shr(b3 & 0x0C, 1) | (b3 & 1), 3))
    t_paint = [
        (t1r, t1g, t1b),
        (_clamp255(t2r + dist_t), _clamp255(t2g + dist_t),
         _clamp255(t2b + dist_t)),
        (t2r, t2g, t2b),
        (_clamp255(t2r - dist_t), _clamp255(t2g - dist_t),
         _clamp255(t2b - dist_t)),
    ]
    h1r = _rep4(_shr(b0 & 0x78, 3))
    h1g = _rep4(_shl(b0 & 0x07, 1) | _shr(b1 & 0x10, 4))
    h1b = _rep4((b1 & 0x08) | _shl(b1 & 0x03, 1) | _shr(b2 & 0x80, 7))
    h2r = _rep4(_shr(b2 & 0x78, 3))
    h2g = _rep4(_shl(b2 & 0x07, 1) | _shr(b3 & 0x80, 7))
    h2b = _rep4(_shr(b3 & 0x78, 3))
    v1 = _shl(h1r, 16) + _shl(h1g, 8) + h1b
    v2 = _shl(h2r, 16) + _shl(h2g, 8) + h2b
    tie = (v1 >= v2).astype(jnp.int32)
    dist_h = _sel_tree(_DIST,
                       _bits_of((b3 & 0x04) | _shl(b3 & 0x01, 1) | tie, 3))
    h_paint = [
        (_clamp255(h1r + dist_h), _clamp255(h1g + dist_h),
         _clamp255(h1b + dist_h)),
        (_clamp255(h1r - dist_h), _clamp255(h1g - dist_h),
         _clamp255(h1b - dist_h)),
        (_clamp255(h2r + dist_h), _clamp255(h2g + dist_h),
         _clamp255(h2b + dist_h)),
        (_clamp255(h2r - dist_h), _clamp255(h2g - dist_h),
         _clamp255(h2b - dist_h)),
    ]
    use_t = mode == 2
    use_h = mode == 3
    # Pack T and H paint entries, then merge: 4 selects on packed
    # words instead of 12 channel selects, and the per-pixel paint
    # select becomes 3 packed cmpsel instead of 9.
    paint_p = [jnp.where(use_h,
                         _pack3(h_paint[k][0], h_paint[k][1],
                                h_paint[k][2]),
                         _pack3(t_paint[k][0], t_paint[k][1],
                                t_paint[k][2])) + _BIAS3
               for k in range(4)]

    # Planar plane colors (decompress-etc.c:287-317).
    b4, b5, b6, b7 = (_byte(w1, k) for k in range(4))
    ro = _shr(b0 & 0x7E, 1)
    go = _shl(b0 & 1, 6) | _shr(b1 & 0x7E, 1)
    bo = (_shl(b1 & 1, 5) | (b2 & 0x18) | _shl(b2 & 0x03, 1)
          | _shr(b3 & 0x80, 7))
    rh = _shr(b3 & 0x7C, 1) | (b3 & 1)
    gh = _shr(b4 & 0xFE, 1)
    bh = _shl(b4 & 1, 5) | _shr(b5 & 0xF8, 3)
    rv = _shl(b5 & 0x7, 3) | _shr(b6 & 0xE0, 5)
    gv = _shl(b6 & 0x1F, 2) | _shr(b7 & 0xC0, 6)
    bv = b7 & 0x3F

    def rep_r(v):
        return _shl(v, 2) | _shr(v & 0x30, 4)

    def rep_g(v):
        return _shl(v, 1) | _shr(v & 0x40, 6)

    ro, rh, rv = rep_r(ro), rep_r(rh), rep_r(rv)
    go, gh, gv = rep_g(go), rep_g(gh), rep_g(gv)
    bo, bh, bv = rep_r(bo), rep_r(bh), rep_r(bv)
    pl_dr, pl_vr = rh - ro, rv - ro
    pl_dg, pl_vg = gh - go, gv - go
    pl_db, pl_vb = bh - bo, bv - bo

    use_planar = mode == 4
    use_ind = (mode == 0)
    nonopq = (~differential) if punchthrough else None

    if not punchthrough:
        sub1_m = tuple(jnp.where(use_ind, i, b)
                       for i, b in zip(ind1, base1))
        sub2_m = tuple(jnp.where(use_ind, i, b)
                       for i, b in zip(ind2, base2))
    else:
        sub1_m, sub2_m = base1, base2
    # Biased packed bases: per pixel ONE select replaces three.
    s1p = _pack3(*sub1_m) + _BIAS3
    s2p = _pack3(*sub2_m) + _BIAS3

    th = use_t | use_h
    planar = (pl_dr, pl_vr, pl_dg, pl_vg, pl_db, pl_vb, ro, go, bo)
    out, keep_out = _swar_pixel_loop(
        piw, flip, a1, b1m, a2, b2m, s1p, s2p, paint_p, th, planar,
        use_planar, punchthrough=punchthrough, nonopq=nonopq)
    return mode, out, (keep_out if punchthrough else None)


def _swar_pixel_loop(piw, flip, a1, b1m, a2, b2m, s1p, s2p, paint_p, th,
                     planar, use_planar, *, punchthrough, nonopq):
    """Shared 16-pixel SWAR loop.  paint_p/planar None = ETC1 path.

    Premultiplied modifier deltas (value * LANE3 hoisted out of the
    pixel loop: 4 block muls replace 16 pixel muls) and per-REGION
    subblock merges: the 8 flip-dependent pixels share two (S, A, B)
    triples selected ONCE per block (6 cmpsel) instead of 3 cmpsel
    per pixel (24)."""
    a1p, b1p = a1 * _LANE3, b1m * _LANE3
    a2p, b2p = a2 * _LANE3, b2m * _LANE3
    flip0 = flip == 0
    # Region X: x >= 2, y < 2 (sub2 iff flip == 0); region Y: x < 2,
    # y >= 2 (sub2 iff flip != 0).
    sab_x = tuple(jnp.where(flip0, t2, t1) for t1, t2 in
                  ((s1p, s2p), (a1p, a2p), (b1p, b2p)))
    sab_y = tuple(jnp.where(flip0, t1, t2) for t1, t2 in
                  ((s1p, s2p), (a1p, a2p), (b1p, b2p)))
    sab_1 = (s1p, a1p, b1p)                  # x < 2, y < 2: always sub1
    sab_2 = (s2p, a2p, b2p)                  # x >= 2, y >= 2: always sub2
    if planar is not None:
        pl_dr, pl_vr, pl_dg, pl_vg, pl_db, pl_vb, ro, go, bo = planar
        # Strength-reduce the planar x*dH + y*dV const multiplies
        # (x, y in 0..3): 2 adds per delta hoisted per block replace
        # 96 int32 muls per block — mul is the expensive operation.

        def multiples(d):
            d2 = d + d
            return (jnp.zeros_like(d), d, d2, d2 + d)

        xm = {c: multiples(d) for c, d in
              (("r", pl_dr), ("g", pl_dg), ("b", pl_db))}
        ym = {c: multiples(d) for c, d in
              (("r", pl_vr), ("g", pl_vg), ("b", pl_vb))}
        base4 = {"r": _shl(ro, 2) + 2, "g": _shl(go, 2) + 2,
                 "b": _shl(bo, 2) + 2}

    out, keep_out = [], []
    for j in range(16):
        i = int(_SRC_I[j])
        x, y = int(_OUT_X[j]), int(_OUT_Y[j])
        lsb = _shr(piw, i) & 1
        msb = _shr(piw, 16 + i) & 1
        pidx = lsb | _shl(msb, 1)

        sp, av, bvm = (sab_1 if x < 2 and y < 2 else
                       sab_2 if x >= 2 and y >= 2 else
                       sab_x if y < 2 else sab_y)
        mag = jnp.where((pidx & 1) != 0, bvm, av)
        if punchthrough:
            mag = jnp.where(nonopq & ((pidx & 1) == 0), 0, mag)
        modifier = jnp.where(pidx >= 2, -mag, mag)
        v = sp + modifier                        # lanes in [73, 694]

        if paint_p is not None:
            # T/H paint: 4-way select of a pre-clamped packed word.
            plo = jnp.where((pidx & 1) != 0, paint_p[1], paint_p[0])
            phi = jnp.where((pidx & 1) != 0, paint_p[3], paint_p[2])
            v = jnp.where(th, jnp.where(pidx >= 2, phi, plo), v)

        if planar is not None:
            # Planar: low-clamped per channel (cheap), packed biased,
            # hi clamp shared with the SWAR clamp below.  Lanes <= 893.
            rp = jnp.maximum((xm["r"][x] + ym["r"][y] + base4["r"]) >> 2, 0)
            gp = jnp.maximum((xm["g"][x] + ym["g"][y] + base4["g"]) >> 2, 0)
            bp = jnp.maximum((xm["b"][x] + ym["b"][y] + base4["b"]) >> 2, 0)
            v = jnp.where(use_planar, _pack3(rp, gp, bp) + _BIAS3, v)

        out.append(_swar_clamp_biased(v))
        if punchthrough:
            # punchthrough always runs the full ETC2 path
            keep_out.append(~(nonopq & (pidx == 2) & ~use_planar))

    return out, keep_out


# ---------------------------------------------------------------------------
# EAC core
# ---------------------------------------------------------------------------

def _eac_codes(w0, w1):
    """16 per-pixel 3-bit codes in output order (decompress-eac.c:48)."""
    be_hi = _bswap32(w0)
    be_lo = _bswap32(w1)
    codes = []
    for j in range(16):
        s = 45 - 3 * int(_SRC_I[j])
        if s >= 32:
            v = _shr(be_hi, s - 32) & 7
        elif s + 3 <= 32:
            v = _shr(be_lo, s) & 7
        else:
            v = (_shr(be_lo, s) | _shl(be_hi, 32 - s)) & 7
        codes.append(v)
    return codes


def _eac_mp_word(w0):
    """Per-block packed EAC modifier row (tidx = byte1 low nibble):
    four 5-bit biased magnitudes in one word, via ONE 16-entry select
    tree."""
    tbits = _bits_of(_shr(w0, 8) & 0xF, 4)
    return _sel_tree(_EAC_MP, tbits)


def _eac_modifier(mp, code):
    """Modifier for a 3-bit code from the PACKED row: a variable
    5-bit-field shift + one negate select (1 cmpsel) instead of the
    former 3-cmpsel select tree per pixel."""
    v = (_shr(mp, (code & 3) * 5) & 31) - 16
    return jnp.where(code >= 4, -v - 1, v)


def _eac_alpha_pixels(w0, w1):
    """ETC2_EAC alpha path (decompress-eac.c:54-86): 16 x (8, L).

    clamp255(base + modifier[c]*mult) takes only 8 values per block:
    build the packed per-block candidate palette once (4 multiplies —
    the negated rows are (-v-1)*mult = -(v*mult) - mult) and make the
    per-pixel work ONE cmpsel + a variable byte shift, multiply-free
    (the packed-palette trick; int32 mul is the expensive integer
    operation)."""
    base = w0 & 0xFF
    mult = _shr(w0, 12) & 0xF
    mp = _eac_mp_word(w0)
    codes = _eac_codes(w0, w1)
    lo = hi = None
    for k in range(4):
        v = (_shr(mp, 5 * k) & 31) - 16          # modifier row value k
        pv = v * mult
        c_pos = _clamp255(base + pv)
        c_neg = _clamp255(base - pv - mult)      # code k+4
        lo = c_pos if k == 0 else lo | _shl(c_pos, 8 * k)
        hi = c_neg if k == 0 else hi | _shl(c_neg, 8 * k)
    out = []
    for c in codes:
        w = jnp.where(c >= 4, hi, lo)
        out.append(_shr(w, _shl(c & 3, 3)) & 0xFF)
    return out, mult


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _etc2_kernel(scal_ref, words_ref, pix_ref, valid_ref):
    w0, w1 = words_ref[0], words_ref[1]
    mode, rgb, _ = _etc2_pixels_swar(w0, w1, punchthrough=False)
    for j in range(16):
        pix_ref[j] = _swar_to_rgba(rgb[j], 0xFF)
    mm = jnp.broadcast_to(scal_ref[0], mode.shape)
    valid_ref[...] = ((_shr(mm, mode) & 1) != 0).astype(jnp.int32)


def _etc2_pt_kernel(scal_ref, words_ref, pix_ref, valid_ref):
    w0, w1 = words_ref[0], words_ref[1]
    opaque = (_byte(w0, 3) & 2) != 0
    mode, rgb, keep = _etc2_pixels_swar(w0, w1, punchthrough=True)
    for j in range(16):
        p = _swar_to_rgba(rgb[j], 0xFF)
        pix_ref[j] = jnp.where(opaque | keep[j], p, 0)
    mm = jnp.broadcast_to(scal_ref[0], mode.shape)
    fl = scal_ref[1]
    valid = (_shr(mm, mode) & 1) != 0
    valid = valid & ~(((fl & 0x4) != 0) & (opaque | (mode == 4)))
    valid = valid & ~(((fl & 0x2) != 0) & ~opaque)
    valid_ref[...] = valid.astype(jnp.int32)


def _etc2_eac_kernel(scal_ref, words_ref, pix_ref, valid_ref):
    aw0, aw1, cw0, cw1 = (words_ref[i] for i in range(4))
    mode, rgb, _ = _etc2_pixels_swar(cw0, cw1, punchthrough=False)
    alpha, mult = _eac_alpha_pixels(aw0, aw1)
    for j in range(16):
        pix_ref[j] = _swar_to_rgba(rgb[j], alpha[j])
    mm = jnp.broadcast_to(scal_ref[0], mode.shape)
    fl = scal_ref[1]
    valid = (_shr(mm, mode) & 1) != 0
    valid = valid & ~(((fl & 0x1) != 0) & (mult == 0))   # FLAG_ENCODE
    valid_ref[...] = valid.astype(jnp.int32)


# ---------------------------------------------------------------------------
# pallas_call plumbing (shared)
# ---------------------------------------------------------------------------

# name -> (kernel, OUTPUT words/block): packed RGBA8, 64 B = the true
# payload (detex.h:879-930 pixel sizes).
_KERNELS = {
    "etc2": (_etc2_kernel, 16),
    "etc2_pt": (_etc2_pt_kernel, 16),
    "etc2_eac": (_etc2_eac_kernel, 16),
}


def _make_decoder(kernel_name, name):
    kernel, n_out = _KERNELS[kernel_name]

    def planar(words_planar, mode_mask=_FULL, flags=0, *,
               interpret=False):
        return planar_call(kernel, words_planar, mode_mask, flags, n_out,
                           interpret=interpret)

    def rows(words, mode_mask=_FULL, flags=0, **kw):
        pix, valid = planar(words.T, mode_mask, flags, **kw)
        return pix.T, valid

    planar.__name__ = planar.__qualname__ = f"{name}_planar"
    rows.__name__ = rows.__qualname__ = name
    return planar, rows


decode_etc2_planar, decode_etc2 = _make_decoder("etc2", "decode_etc2")
decode_etc2_punchthrough_planar, decode_etc2_punchthrough = \
    _make_decoder("etc2_pt", "decode_etc2_punchthrough")
decode_etc2_eac_planar, decode_etc2_eac = _make_decoder(
    "etc2_eac", "decode_etc2_eac")
