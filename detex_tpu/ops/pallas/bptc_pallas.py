"""BC7 (BPTC) block decode as a fused Pallas kernel, compiled for the
GPU through Triton (ops/pallas.planar_call).

Same contract and bit-exact semantics as ops.bptc.decode_bptc
(reference: decompress-bptc.c:354-512), implemented as one pass per
block with no gathers:

  * layout: words (4, N) int32 in, pixels (16, N) packed RGBA8 + (N,)
    validity out.
  * every per-mode stream offset is *derived arithmetically* from a
    handful of per-mode constants (8-way select chains);
    the derivations are verified against the table-driven layout of
    ops.bptc at import time.
  * the only true table lookups (bptc-tables.c:23-188) are compressed
    to two select trees: subset ids bit-packed one int32 per
    (ns, partition) gathered by a 64-way binary select tree, and
    anchor POSITIONS packed 2-partitions/word gathered by a 32-way
    tree; the anchors-before counts are not a table at all — they are
    derived in-kernel as the exclusive prefix popcount of the anchor
    bitmap (bit-spread + one multiply).  No table in device memory,
    no XLA gather op.
  * bitfield extraction = two-word funnel shift with the word pair
    chosen by a 4-way select (replaces reference bits.c:22-44);
    endpoint fields stream through one 64-bit window per channel
    advanced by funnel shifts; header fields (partition id, rotation,
    index-swap) end by bit 18 in every mode and are read straight
    from word 0.
  * interpolation weights are computed arithmetically: the aWeight
    tables (bptc-tables.c:190-201) equal floor((64*i + c)/d) with
    (c,d) = (1,3)/(3,7)/(7,15); the divisions are exact multiply-shift
    magics, verified against the tables at import time.

decode_bptc_planar takes planar words; decode_bptc wraps it with
(N, 4) <-> (N, 16) transposes for drop-in parity with
ops.bptc.decode_bptc (the engine decoder table's layout).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from detex_tpu.ops import bptc_fast as BF
from detex_tpu.ops.pallas import planar_call

_FULL = 0xFFFFFFFF

# Per-mode scalar constants (decompress-bptc.c:45-71).
_NS = np.asarray(BF._T_NS)
_PB = np.asarray(BF._T_PB)
_CP = np.asarray(BF._T_CP)
_CPP = np.asarray(BF._T_CPP)
_AP = np.asarray(BF._T_AP)
_APP = np.asarray(BF._T_APP)
_IB = np.asarray(BF._T_IB)
_IB2 = np.asarray(BF._T_IB2)
_HASPB = (_CPP > _CP) | (_APP > _AP)

# All nine per-mode scalar constants bit-packed into ONE word per mode
# so the kernel's mode gather is a single 8-entry select chain instead
# of ten (layout asserted in range below):
#   ns:0-1  pb:2-4  cp:5-7  cpp:8-11  ap:12-15  app:16-19  ib:20-22
#   ib2:23-24  haspb:25
for _arr, _w in ((_NS, 2), (_PB, 3), (_CP, 3), (_CPP, 4), (_AP, 4),
                 (_APP, 4), (_IB, 3), (_IB2, 2)):
    assert int(np.max(_arr)) < (1 << _w), _arr
_MODEC = (_NS | (_PB << 2) | (_CP << 5) | (_CPP << 8) | (_AP << 12)
          | (_APP << 16) | (_IB << 20) | (_IB2 << 23)
          | (_HASPB.astype(np.int64) << 25)).astype(np.int32)

# ---------------------------------------------------------------------------
# Packed partition tables, indexed q = (ns-1)*64 + psid:
#   SUB32: 16 x 2-bit subset ids      BEF32: 16 x 2-bit anchors-before
#   ANC16: 16 x 1-bit is-anchor bitmap
# ---------------------------------------------------------------------------


def _build_packed():
    subset = np.asarray(BF._T_SUBSET).reshape(192, 16)
    is_anchor = np.zeros((3, 64, 16), bool)
    is_anchor[:, :, 0] = True
    a = np.arange(64)
    anchors = np.asarray(BF._T_ANCHORS)
    is_anchor[1, a, anchors[:, 0]] = True
    is_anchor[2, a, anchors[:, 1]] = True
    is_anchor[2, a, anchors[:, 2]] = True
    is_anchor = is_anchor.reshape(192, 16)
    before = np.cumsum(is_anchor, axis=1) - is_anchor

    def pack(vals, bits):
        out = np.zeros(192, np.uint64)
        for i in range(16):
            out |= (vals[:, i].astype(np.uint64)) << (bits * i)
        return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)

    return pack(subset, 2), pack(before, 2), pack(is_anchor, 1)


_SUB32, _BEF32, _ANC16 = _build_packed()

# ns == 2 subset rows are 1 bit/pixel: pack them 2 psids/word so the
# gather is a 32-entry tree + a 16-bit pick + a bit spread (≈41 ops)
# instead of a 64-entry tree (63).  The spread (bit i -> bit 2i)
# reconstructs the 2-bit-lane SUB32 form exactly (asserted below).


def _build_sub16p2():
    subset = np.asarray(BF._T_SUBSET).reshape(192, 16)[64:128]
    v16 = np.zeros(64, np.uint64)
    for i in range(16):
        v16 |= subset[:, i].astype(np.uint64) << i
    p2 = (v16[0::2] | (v16[1::2] << 16)).astype(np.uint32).view(np.int32)
    for p in range(64):
        sp = int(v16[p])
        sp = (sp | (sp << 8)) & 0x00FF00FF
        sp = (sp | (sp << 4)) & 0x0F0F0F0F
        sp = (sp | (sp << 2)) & 0x33333333
        sp = (sp | (sp << 1)) & 0x55555555
        assert sp == int(np.int64(_SUB32[64 + p]) & 0xFFFFFFFF), p
    return p2


_SUB16P2 = _build_sub16p2()

# Anchor POSITIONS packed 2-per-word (a0 = ns2 anchor, a1/a2 = ns3
# anchors, 4 bits each -> 12 bits/psid): one 32-entry select tree
# replaces the two 64-entry ANC16 gathers, and BEF32 is then derived
# arithmetically in-kernel (it is the exclusive prefix popcount of the
# anchor bitmap — see `before = cumsum(is_anchor) - is_anchor` above).


def _build_anchor_pos():
    anchors = np.asarray(BF._T_ANCHORS).astype(np.uint32)
    p = anchors[:, 0] | (anchors[:, 1] << 4) | (anchors[:, 2] << 8)
    p2 = (p[0::2] | (p[1::2] << 12)).astype(np.uint32).view(np.int32)

    # Verify the in-kernel reconstruction against the packed tables
    # for every (ns, psid) row.
    psid = np.arange(64)
    pos = p[psid].astype(np.int64)
    a0, a1, a2 = pos & 0xF, (pos >> 4) & 0xF, (pos >> 8) & 0xF
    anc = {1: np.ones(64, np.int64),
           2: (1 << a0) | 1,
           3: (1 << a1) | (1 << a2) | 1}
    for ns_chk in (1, 2, 3):
        rows = (ns_chk - 1) * 64 + psid
        want_anc = np.asarray(_ANC16[rows], np.int64) & 0xFFFFFFFF
        assert np.array_equal(anc[ns_chk], want_anc), ns_chk
        s = anc[ns_chk]
        s = (s | (s << 8)) & 0x00FF00FF
        s = (s | (s << 4)) & 0x0F0F0F0F
        s = (s | (s << 2)) & 0x33333333
        s = (s | (s << 1)) & 0x55555555
        bef = (s * 0x55555555 - s) & 0xFFFFFFFF
        want_bef = np.asarray(_BEF32[rows], np.int64) & 0xFFFFFFFF
        assert np.array_equal(bef, want_bef), ns_chk
    return p2


_ANCPOS2 = _build_anchor_pos()

# Verify the arithmetic stream-offset derivations against the
# table-driven layout (ops.bptc._mode_layout / bptc_fast tables).
for _m in range(8):
    _lay = BF._LAY[_m]
    _ep = _lay["ep"]
    assert _lay["pb"] == _m + 1
    assert _lay["rb"] == _m + 1 + _PB[_m]
    assert _lay["isb"] == _lay["rb"] + (2 if _m in (4, 5) else 0)
    assert _ep == _lay["isb"] + (1 if _m == 4 else 0)
    assert _lay["alpha"] == _ep + _CP[_m] * _NS[_m] * 6
    assert _lay["pbit"] == _lay["alpha"] + _AP[_m] * _NS[_m] * 2
    _npb = (2 if _m == 1 else _NS[_m] * 2) if _HASPB[_m] else 0
    assert _lay["index"] == _lay["pbit"] + _npb
    assert (BF._MODE_STATIC[_m]["sec_start"]
            == _lay["index"] + _IB[_m] * 16 - _NS[_m])
    for _c in range(3):
        for _j in range(_NS[_m]):
            for _k in range(2):
                assert (BF._T_EP_OFF[_m, _c, _j, _k]
                        == _ep + (_c * _NS[_m] * 2 + _j * 2 + _k)
                        * _CP[_m])
    if _AP[_m]:
        for _j in range(_NS[_m]):
            for _k in range(2):
                assert (BF._T_EP_OFF[_m, 3, _j, _k]
                        == _lay["alpha"] + (_j * 2 + _k) * _AP[_m])

# Multiply-shift magics for the aWeight tables.
for _bits, (_c, _mul, _sh) in {2: (1, 683, 11), 3: (3, 9363, 16),
                               4: (7, 34953, 19)}.items():
    _i = np.arange(1 << _bits)
    _w = ((64 * _i + _c) * _mul) >> _sh
    assert np.array_equal(_w, BF._WEIGHTS[_bits]), (_bits, _w)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

def _shr(x, n):
    return lax.shift_right_logical(x, n)


def _shl(x, n):
    return lax.shift_left(x, n)


def _vmask(width):
    """(1 << width) - 1 for vector widths in [0, 16]."""
    return _shl(jnp.ones_like(width), width) - 1


def _extract_mode_v(b0):
    """Lowest set bit of byte0; none -> -1 (decompress-bptc.c:229-237)."""
    mode = jnp.full(b0.shape, -1, jnp.int32)
    for i in range(7, -1, -1):
        mode = jnp.where((b0 & (1 << i)) != 0, i, mode)
    return mode


def _gather_tree(tab, bits):
    """Gather from a 2**len(bits)-entry int32 numpy table by a vector
    index given as precomputed boolean bit vectors (LSB first) — a
    binary select tree (2**n - 1 selects, no memory; replaces an XLA
    gather op)."""
    cur = [int(v) for v in tab]
    for b in bits:
        cur = [jnp.where(b, hi, lo)
               for lo, hi in zip(cur[0::2], cur[1::2])]
    return cur[0]


def _bc7_kernel(scal_ref, words_ref, pix_ref, valid_ref):
    w = [words_ref[i] for i in range(4)]          # each (8, L)

    def funnel(lo, hi, bit):
        """(lo | hi<<32) >> bit for bit in [0,31], branch-free: the
        double shift (hi<<1)<<(31-bit) equals hi<<(32-bit) and is 0
        at bit==0 without a select."""
        return _shr(lo, bit) | _shl(_shl(hi, 1), 31 - bit)

    def dynf(start, width: int):
        """width<=16 bits at dynamic bit offset `start` (vector)."""
        w0 = _shr(start, 5)
        bit = start & 31
        lo = jnp.where(w0 == 0, w[0],
                       jnp.where(w0 == 1, w[1],
                                 jnp.where(w0 == 2, w[2], w[3])))
        hi = jnp.where(w0 == 0, w[1],
                       jnp.where(w0 == 1, w[2], w[3]))
        return funnel(lo, hi, bit) & ((1 << width) - 1)

    def window64(start):
        """(P0, P1) = 64 bits of the block at dynamic offset `start`
        (start in [0,128)); bits past the end read as 0.  Lets the
        per-pixel extraction use a 2-way word pick instead of dynf's
        4-way chains (the index streams span < 64 bits)."""
        w0 = _shr(start, 5)
        bit = start & 31
        zero = jnp.zeros_like(start)
        lo0 = jnp.where(w0 == 0, w[0],
                        jnp.where(w0 == 1, w[1],
                                  jnp.where(w0 == 2, w[2], w[3])))
        lo1 = jnp.where(w0 == 0, w[1],
                        jnp.where(w0 == 1, w[2],
                                  jnp.where(w0 == 2, w[3], zero)))
        lo2 = jnp.where(w0 == 0, w[2],
                        jnp.where(w0 == 1, w[3], zero))
        return funnel(lo0, lo1, bit), funnel(lo1, lo2, bit)

    mode_raw = _extract_mode_v(w[0] & 0xFF)
    mode = jnp.maximum(mode_raw, 0)

    def msel(tab):
        """Per-block gather from an 8-entry mode table (select chain)."""
        out = jnp.full(mode.shape, int(tab[7]), jnp.int32)
        for m in range(6, -1, -1):
            out = jnp.where(mode == m, int(tab[m]), out)
        return out

    mc = msel(_MODEC)
    ns = mc & 3
    pb_w = _shr(mc, 2) & 7
    cp, cpp = _shr(mc, 5) & 7, _shr(mc, 8) & 0xF
    ap, app = _shr(mc, 12) & 0xF, _shr(mc, 16) & 0xF
    ib, ib2 = _shr(mc, 20) & 7, _shr(mc, 23) & 3
    has_pb = _shr(mc, 25) & 1
    is_m1 = mode == 1
    is_m4 = mode == 4
    is_m6 = mode == 6

    # Stream offsets, derived arithmetically (verified at import).
    pb_start = mode + 1
    rb_w = jnp.where(is_m4 | (mode == 5), 2, 0)
    isb_start = pb_start + pb_w + rb_w
    ep_base = isb_start + jnp.where(is_m4, 1, 0)
    ns2 = ns * 2
    alpha_base = ep_base + cp * ns * 6
    pbit_base = alpha_base + ap * ns2
    index_start = pbit_base + has_pb * jnp.where(is_m1, 2, ns2)
    sec_start = index_start + ib * 16 - ns

    # pb/rot/isb fields end by bit 18 in every mode, so they always
    # live in word 0: direct shifts replace three dynf calls.
    psid = _shr(w[0], pb_start) & _vmask(pb_w)
    rot = _shr(w[0], pb_start + pb_w) & _vmask(rb_w)
    isb = jnp.where(is_m4, _shr(w[0], isb_start) & 1, 0)

    # Partition-table lookups via select trees.  ns == 1 rows are
    # constants: subset 0 everywhere, pixel 0 the only anchor.
    pbits_vec = [(psid & (1 << i)) != 0 for i in range(6)]

    # ns == 2: 32-entry tree over 2-psids/word 1-bit rows + bit
    # spread to 2-bit lanes; ns == 3 keeps the 64-entry tree.
    sub16_2 = _gather_tree(_SUB16P2, pbits_vec[1:6])
    sub16 = jnp.where(pbits_vec[0], _shr(sub16_2, 16), sub16_2) & 0xFFFF
    sp = sub16
    sp = (sp | _shl(sp, 8)) & 0x00FF00FF
    sp = (sp | _shl(sp, 4)) & 0x0F0F0F0F
    sp = (sp | _shl(sp, 2)) & 0x33333333
    sp = (sp | _shl(sp, 1)) & 0x55555555
    g3 = _gather_tree(_SUB32[128:192], pbits_vec)
    sub32 = jnp.where(ns == 1, 0, jnp.where(ns == 2, sp, g3))

    # Anchor bitmap from ONE 32-entry tree of packed anchor positions
    # (2 psids/word, 12 bits each) instead of two 64-entry ANC16
    # gathers; verified against the packed tables at import.
    pos2 = _gather_tree(_ANCPOS2, pbits_vec[1:6])
    pos = jnp.where(pbits_vec[0], _shr(pos2, 12), pos2) & 0xFFF
    one_v = jnp.ones_like(pos)
    anc16 = jnp.where(ns == 2, _shl(one_v, pos & 0xF),
                      jnp.where(ns == 3,
                                _shl(one_v, _shr(pos, 4) & 0xF)
                                | _shl(one_v, _shr(pos, 8)), 0)) | 1

    # BEF32 == exclusive prefix popcount of the anchor bitmap in 2-bit
    # lanes (by construction, _build_packed): spread the 16 bits to
    # even positions, then one multiply accumulates the prefix sums
    # (inclusive counts are <= 3, so no carry crosses a lane).
    s = anc16
    s = (s | _shl(s, 8)) & 0x00FF00FF
    s = (s | _shl(s, 4)) & 0x0F0F0F0F
    s = (s | _shl(s, 2)) & 0x33333333
    s = (s | _shl(s, 1)) & 0x55555555
    bef32 = s * 0x55555555 - s

    # --- endpoints: ep[c][j][k], dequantized to 8 bits ------------------
    no_alpha = ap == 0
    # ONE 8-bit read covers the whole p-bit stream (<= 6 bits); each
    # p-bit is then a variable shift instead of its own dynf.
    pball = dynf(pbit_base, 8)
    pbit = [[None, None] for _ in range(3)]
    for j in range(3):
        for k in range(2):
            idx = jnp.where(is_m1, j, j * 2 + k)
            pb = _shr(pball, idx) & 1
            if k == 1:
                # mode 6 reads both p-bits from data0 >> 63, so the
                # second one is always 0 (decompress-bptc.c:142-146)
                pb = jnp.where(is_m6, 0, pb)
            pbit[j][k] = pb
    # Endpoint reads, one 64-bit window per channel: a channel's six
    # fields span 6*cp <= 42 bits, so window64 at the channel base +
    # five funnel advances by cp replace six independent dynf calls
    # (each with its own 4-way word pick).
    ep = [[[None, None] for _ in range(3)] for _ in range(4)]
    for c in range(4):
        pp = app if c == 3 else cpp
        p = ap if c == 3 else cp
        stride = ap if c == 3 else cp
        has_p = pp > p
        pmask = _vmask(p)
        shift_up = (8 - pp) & 31
        if c == 3:
            base = alpha_base
        else:
            base = ep_base + c * ns2 * cp
        wlo, whi = window64(base)
        for j in range(3):
            for k in range(2):
                raw = wlo & pmask
                if not (j == 2 and k == 1):
                    wlo = funnel(wlo, whi, stride)
                    whi = _shr(whi, stride)
                v = jnp.where(has_p, _shl(raw, 1) | pbit[j][k], raw)
                v = _shl(v, shift_up)
                v = v | _shr(v, pp)
                if c == 3:
                    v = jnp.where(no_alpha, 0xFF, v)
                ep[c][j][k] = v & 0xFF

    # SWAR interpolation in d-form, hoisted per block:
    #   v = (e0 << 6) + w * (e1 - e0) + bias
    # is bit-identical to (64-w)*e0 + w*e1 + bias (the reference's
    # decompress-bptc.c:332 form after distributing) but costs ONE
    # multiply per pixel instead of two.  For the packed (r | b<<16)
    # pair the identity survives packing: with pack = r + 2^16*b,
    # d = pack1 - pack0 = (r1-r0) + 2^16*(b1-b0) as an integer, and
    # base + w*d + 0x200020 = (64*r0 + w*dr + 32) + 2^16*(64*b0 +
    # w*db + 32); each parenthesis lies in [32, 16352], so the packed
    # sum is exactly the lane concatenation (no borrow can cross —
    # intermediate negatives in w*d resolve in exact i32 arithmetic).
    rb_base = [_shl(ep[0][j][0] | _shl(ep[2][j][0], 16), 6) + 0x200020
               for j in range(3)]
    rb_d = [(ep[0][j][1] | _shl(ep[2][j][1], 16))
            - (ep[0][j][0] | _shl(ep[2][j][0], 16)) for j in range(3)]
    g_base = [_shl(ep[1][j][0], 6) + 32 for j in range(3)]
    g_d = [ep[1][j][1] - ep[1][j][0] for j in range(3)]
    a_base = [_shl(ep[3][j][0], 6) + 32 for j in range(3)]
    a_d = [ep[3][j][1] - ep[3][j][0] for j in range(3)]

    # --- per-block index-stream parameters ------------------------------
    has_sec = ib2 > 0
    isb_on = isb != 0
    color_bits = jnp.where(has_sec & isb_on, ib2, ib + isb)
    alpha_bits = jnp.where(has_sec, jnp.where(isb_on, ib, ib2), ib)

    # Weight = floor((64*idx + c)/d): hoist the multiply-shift magic
    # per block (the 2/3/4-bit variants share one (mul, shift, cadd)
    # triple selected here, not per pixel).
    def wmagic(bits):
        mul = jnp.where(bits == 2, 683, jnp.where(bits == 3, 9363, 34953))
        sh = jnp.where(bits == 2, 11, jnp.where(bits == 3, 16, 19))
        c = jnp.where(bits == 2, 1, jnp.where(bits == 3, 3, 7))
        return mul, sh, c

    wc_mul, wc_sh, wc_c = wmagic(color_bits)
    wa_mul, wa_sh, wa_c = wmagic(alpha_bits)
    # Fold floor((64*idx + c) / d) = (idx*(mul<<6) + c*mul) >> sh so
    # the per-pixel weight is mul+add+shift (products stay < 2^30).
    wc_mul64, wc_cm = _shl(wc_mul, 6), wc_c * wc_mul
    wa_mul64, wa_cm = _shl(wa_mul, 6), wa_c * wa_mul
    # Pre-align two 64-bit windows at the stream starts: per-pixel
    # offsets (ib*i - before <= 60) then need only a 2-way word pick
    # (replaces the serial bit cursor of decompress-bptc.c:400-480).
    p_lo, p_hi = window64(index_start)
    s_lo, s_hi = window64(sec_start)
    sel_ci = has_sec & isb_on
    sel_ai = has_sec & ~isb_on

    # Pre-select the COLOR and ALPHA streams per block (window, step,
    # width mask): retires the two per-pixel color_idx/alpha_idx
    # selects (32 cmpsel/block) for 8 block-level selects.
    c_lo = jnp.where(sel_ci, s_lo, p_lo)
    c_hi = jnp.where(sel_ci, s_hi, p_hi)
    a_lo = jnp.where(sel_ai, s_lo, p_lo)
    a_hi = jnp.where(sel_ai, s_hi, p_hi)
    c_step = jnp.where(sel_ci, ib2, ib)
    a_step = jnp.where(sel_ai, ib2, ib)
    full_c = _vmask(c_step)
    full_a = _vmask(a_step)

    # Rotation (modes 4/5) swaps alpha with one color channel AFTER
    # interpolation — a pure output-position permutation, so it is
    # four per-block BYTE SHIFT AMOUNTS instead of six selects per
    # pixel (rot == 0 elsewhere makes them the identity placement).
    s_r = jnp.where(rot == 1, 24, 0)
    s_g = jnp.where(rot == 2, 24, 8)
    s_b = jnp.where(rot == 3, 24, 16)
    s_a = jnp.where(rot == 0, 24, _shl(rot - 1, 3))

    # --- 16 pixels -------------------------------------------------------
    ci_cur = jnp.zeros_like(ib)
    ai_cur = jnp.zeros_like(ib)
    for i in range(16):
        subset = _shr(sub32, 2 * i) & 3
        before = _shr(bef32, 2 * i) & 3
        anch_bit = _shr(anc16, i) & 1

        off_c = ci_cur - before
        hi_c = off_c >= 32
        color_idx = funnel(jnp.where(hi_c, c_hi, c_lo),
                           jnp.where(hi_c, 0, c_hi), off_c & 31) \
            & _shr(full_c, anch_bit)
        off_a = ai_cur - before
        hi_a = off_a >= 32
        alpha_idx = funnel(jnp.where(hi_a, a_hi, a_lo),
                           jnp.where(hi_a, 0, a_hi), off_a & 31) \
            & _shr(full_a, anch_bit)
        if i < 15:
            ci_cur = ci_cur + c_step
            ai_cur = ai_cur + a_step

        w_c = _shr(color_idx * wc_mul64 + wc_cm, wc_sh)
        w_a = _shr(alpha_idx * wa_mul64 + wa_cm, wa_sh)

        def sel3(vals):
            return jnp.where(subset == 1, vals[1],
                             jnp.where(subset == 2, vals[2], vals[0]))

        # rb pair: both lanes weighted by w_c (one mul, d-form)
        v_rb = sel3(rb_base) + w_c * sel3(rb_d)
        r = _shr(v_rb, 6) & 0xFF
        b = _shr(v_rb, 22) & 0xFF
        # g / a: distinct weights -> one mul each on the hoisted deltas
        g = (sel3(g_base) + w_c * sel3(g_d)) >> 6
        a = (sel3(a_base) + w_a * sel3(a_d)) >> 6
        pix_ref[i] = (_shl(r, s_r) | _shl(g, s_g) | _shl(b, s_b)
                      | _shl(a, s_a))

    # --- validity (decompress-bptc.c:361-369) ----------------------------
    mm = jnp.broadcast_to(scal_ref[0], mode.shape)
    fl = scal_ref[1]
    mm_bit = _shr(mm, jnp.clip(mode_raw, 0, 31)) & 1
    valid = (mode_raw >= 0) & (mm_bit != 0)
    valid = valid & ~(((fl & 0x2) != 0) & (mode_raw >= 4))
    valid = valid & ~(((fl & 0x4) != 0) & (mode_raw < 4))
    valid_ref[...] = valid.astype(jnp.int32)


def decode_bptc_planar(words_planar, mode_mask: int = _FULL,
                       flags: int = 0, *, interpret: bool = False):
    """BC7 decode, planar layout: (4, N) int32 words ->
    ((16, N) int32 packed RGBA8, (N,) bool valid)."""
    return planar_call(_bc7_kernel, words_planar, mode_mask, flags, 16,
                       interpret=interpret)


def decode_bptc(words, mode_mask: int = _FULL, flags: int = 0, **kw):
    """Drop-in for ops.bptc.decode_bptc: (N, 4) int32 words ->
    ((N, 16) int32, (N,) bool)."""
    pix, valid = decode_bptc_planar(words.T, mode_mask, flags, **kw)
    return pix.T, valid
