"""BC6H (BPTC_FLOAT / BPTC_SIGNED_FLOAT) decode as a fused Pallas kernel,
compiled for the GPU through Triton (ops/pallas.planar_call).

Bit-exact re-implementation of ops.bptc_float (reference:
decompress-bptc-float.c:110-644) as a single pass per block.  The reference's
14-mode switch of hand-written bit scatters stays *static*: the kernel
unrolls all 14 modes (every field extraction is a static two-word
funnel, 2-3 ops), runs each mode's delta + unquantize arithmetic, and
selects the surviving endpoint set per block by the detected mode — the
per-block work is integer arithmetic with no gathers.  Partition subset bits,
anchors-before counts, and anchor bitmaps for the 2-subset modes are
bit-packed per partition id and gathered by 32-way select trees.

Layout identical to bptc_pallas: words (4, N) int32 in; output is
the TRUE FLOAT_RGBX16 payload (detex.h:879-930: 8 B/pixel), packed as
a (32, N) int32 stack — rows 2i = R|G<<16, rows 2i+1 = B|X<<16
(X = 0) for pixel i — plus (N,) validity.  128 B out per block, no
write amplification.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
from jax import lax

from detex_tpu.ops import bptc_float as BFJ
from detex_tpu.ops.bptc import _ANCHOR2, _P2
from detex_tpu.ops.pallas import planar_call

_FULL = 0xFFFFFFFF

_EPB = BFJ._EPB
_DELTA = BFJ._DELTA
_FIELDS = BFJ._FIELDS

# Packed per-partition tables for the 2-subset modes (BC6H uses 5-bit
# partition ids -> 32 entries; decompress-bptc-float.c:529-541).
_SUB16 = np.zeros(32, np.int64)
_BEF32 = np.zeros(32, np.int64)
_ANC16 = np.zeros(32, np.int64)
for _p in range(32):
    is_anchor = np.zeros(16, bool)
    is_anchor[0] = True
    is_anchor[_ANCHOR2[_p]] = True
    before = np.cumsum(is_anchor) - is_anchor
    for _i in range(16):
        _SUB16[_p] |= int(_P2[_p, _i] & 1) << _i
        _BEF32[_p] |= int(before[_i]) << (2 * _i)
        _ANC16[_p] |= int(is_anchor[_i]) << _i
_SUB16 = (_SUB16 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
_BEF32 = (_BEF32 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
_ANC16 = (_ANC16 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)

# Subset bitmap + second-anchor position packed in ONE word per
# partition (20 bits): one 32-entry select tree replaces the three
# SUB16/BEF32/ANC16 gathers; the anchor bitmap and the
# anchors-before counts are reconstructed arithmetically in-kernel
# (BEF32 is the exclusive prefix popcount of the anchor bitmap).
_SUBANC = (_SUB16.astype(np.int64) & 0xFFFF) \
    | (np.asarray(_ANCHOR2, np.int64)[:32] << 16)
_SUBANC = (_SUBANC & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
for _p in range(32):
    _a1 = int(_SUBANC[_p]) >> 16 & 0xF
    _anc = (1 << _a1) | 1
    assert _anc == int(_ANC16[_p]), _p
    _sp = _anc
    _sp = (_sp | (_sp << 8)) & 0x00FF00FF
    _sp = (_sp | (_sp << 4)) & 0x0F0F0F0F
    _sp = (_sp | (_sp << 2)) & 0x33333333
    _sp = (_sp | (_sp << 1)) & 0x55555555
    assert ((_sp * 0x55555555 - _sp) & 0xFFFFFFFF
            == int(np.int64(_BEF32[_p]) & 0xFFFFFFFF)), _p

# ns == 1 modes: 4-bit indices from bit 65, pixel 0 anchored
# (decompress-bptc-float.c:543-551).
_OFF_1 = [65 + 4 * i - (1 if i > 0 else 0) for i in range(16)]

# Verify the weight magics (same as bptc_pallas).
from detex_tpu.ops.bptc import _WEIGHTS  # noqa: E402
for _bits, (_c, _mul, _sh) in {3: (3, 9363, 16), 4: (7, 34953, 19)}.items():
    _i = np.arange(1 << _bits)
    assert np.array_equal(((64 * _i + _c) * _mul) >> _sh, _WEIGHTS[_bits])


def _shr(x, n):
    return lax.shift_right_logical(x, n)


def _shl(x, n):
    return lax.shift_left(x, n)


def _sel_tree32(tab, bits5):
    cur = [int(v) for v in tab]
    for b in bits5:
        cur = [jnp.where(b, hi, lo) for lo, hi in zip(cur[0::2], cur[1::2])]
    return cur[0]


def _make_sfield(w):
    """Static bitfield reader over the four 32-bit words, memoized per
    (lo, width) — the 14 mode layouts re-read many identical fields
    (XLA would CSE them anyway; memoizing keeps the traced jaxpr and
    the op census honest and speeds tracing)."""
    cache = {}

    def sfield(lo: int, width: int):
        key = (lo, width)
        if key in cache:
            return cache[key]
        wi, bit = lo // 32, lo % 32
        if bit + width <= 32:
            out = _shr(w[wi], bit) & ((1 << width) - 1)
        else:
            lo_part = _shr(w[wi], bit)
            hi_part = _shl(w[wi + 1], 32 - bit)
            out = (lo_part | hi_part) & ((1 << width) - 1)
        cache[key] = out
        return out
    return sfield


def _bc6h_kernel(scal_ref, words_ref, out_ref, valid_ref, *, signed: bool):
    w = [words_ref[i] for i in range(4)]
    sfield = _make_sfield(w)

    # --- mode (decompress-bptc-float.c:23-33, 487-494) -------------------
    m2 = w[0] & 3
    code5 = w[0] & 31
    c_shift = _shr(code5, 2)
    mode_raw = jnp.where(
        m2 < 2, m2,
        jnp.where(m2 == 2, 2 + c_shift,
                  jnp.where(code5 < 16, 10 + c_shift, -1)))
    mode = jnp.maximum(mode_raw, 0)

    def sign_extend(v, bits: int):
        half = 1 << (bits - 1)
        return ((v & ((1 << bits) - 1)) ^ half) - half

    # --- all 14 modes: RAW endpoint fields -> one select -----------------
    # The per-mode work is ONLY the field scatter (the layouts differ);
    # the delta-add + unquantize arithmetic is identical in *shape*
    # across modes and runs ONCE on the selected raw values with
    # per-block constant vectors (epb / delta-bit masks chosen by mode
    # via 4-bit select trees).  Cuts ~1/3 of the kernel's integer ops vs
    # running the endpoint math 14 times (decompress-bptc-float.c
    # semantics unchanged; goldens + fuzz pin bit-exactness).
    keys = [f"{c}{i}" for c in "rgb" for i in range(4)]
    ep_by_mode = []
    for m in range(14):
        ep = {k: 0 for k in keys}
        for f in _FIELDS[m]:
            dest, lo, hi, shift = f[0], f[1], f[2], f[3]
            rev = len(f) > 4 and f[4]
            if rev:
                val = 0
                for i in range(hi - lo + 1):
                    val = val | _shl(sfield(hi - i, 1), i)
            else:
                val = sfield(lo, hi - lo + 1)
            sval = _shl(val, shift) if shift else val
            ep[dest] = sval if isinstance(ep[dest], int) else ep[dest] | sval
        ep_by_mode.append(ep)

    # Per-key BALANCED select tree over the 4 mode bits (depth 4)
    # instead of the former 13-deep sequential where chain per key —
    # same cmpsel count, 3x shorter dependency chains for the
    # scheduler.  Keys a mode does not populate select zeros there
    # (unused downstream: ns==1 blocks never read e2/e3).
    mbits = [(mode & (1 << i)) != 0 for i in range(4)]
    zero_v = jnp.zeros_like(mode)
    raw = {}
    for key in keys:
        leaves = [ep_by_mode[m][key] for m in range(14)]
        leaves = [zero_v if isinstance(v, int) else v for v in leaves]
        cur = leaves + [leaves[-1]] * 2          # pad 14 -> 16
        for b in mbits:
            cur = [jnp.where(b, hi, lo)
                   for lo, hi in zip(cur[0::2], cur[1::2])]
        raw[key] = cur[0]

    # Per-block mode-dependent constants (4-bit select trees; mbits
    # shared with the raw-field trees above).

    def mode_const(tab14):
        t = list(tab14) + [tab14[-1]] * 2      # pad 14 -> 16 leaves
        return _sel_tree32(t, mbits)

    epb_mask_v = mode_const([(1 << e) - 1 for e in _EPB])
    epb_half_v = mode_const([1 << (e - 1) for e in _EPB])
    epb_sh_v = mode_const([e - 1 for e in _EPB])
    is16 = epb_sh_v == 15                      # mode 13: no unquantize
    has_delta = mode_const(
        [0 if d is None else 1 for d in _DELTA]) != 0
    db_mask = {}
    db_half = {}
    for ci, c in enumerate("rgb"):
        db_mask[c] = mode_const(
            [0 if d is None else (1 << d[ci]) - 1 for d in _DELTA])
        db_half[c] = mode_const(
            [1 if d is None else 1 << (d[ci] - 1) for d in _DELTA])

    def sext_v(v, mask, half):
        return ((v & mask) ^ half) - half

    final = {}
    for ci, c in enumerate("rgb"):
        e = [raw[f"{c}{i}"] for i in range(4)]
        e0s = sext_v(e[0], epb_mask_v, epb_half_v) if signed else e[0]
        outs = [e0s]
        for i in range(1, 4):
            d = sext_v(e[i], db_mask[c], db_half[c])
            dv = (e0s + d) & epb_mask_v
            plain = e[i]
            if signed:
                dv = sext_v(dv, epb_mask_v, epb_half_v)
                plain = sext_v(plain, epb_mask_v, epb_half_v)
            outs.append(jnp.where(has_delta, dv, plain))
        # unquantize (decompress-bptc-float.c:52-86), vector epb
        for i in range(4):
            x = outs[i]
            if signed:
                mag = jnp.abs(x)
                unq = _shr(_shl(mag, 15) + 0x4000, epb_sh_v)
                unq = jnp.where(mag == 0, 0,
                                jnp.where(mag >= epb_half_v - 1,
                                          0x7FFF, unq))
                x = jnp.where(is16, x, jnp.sign(x) * unq)
            else:
                unq = _shr(_shl(x, 15) + 0x4000, epb_sh_v)
                xu = jnp.where(x == 0, 0,
                               jnp.where(x == epb_mask_v, 0xFFFF, unq))
                x = jnp.where(is16, x, xu)
            final[f"{c}{i}"] = x

    # --- shared pixel loop ------------------------------------------------
    ns1 = mode >= 10
    psid = sfield(77, 5)
    pbits = [(psid & (1 << i)) != 0 for i in range(5)]
    subanc = _sel_tree32(_SUBANC, pbits)
    sub16 = subanc & 0xFFFF
    anc16 = _shl(jnp.ones_like(subanc), _shr(subanc, 16)) | 1
    # BEF32 == exclusive prefix popcount of the anchor bitmap in
    # 2-bit lanes (counts <= 2, so the multiply trick cannot carry
    # across lanes); verified against the table at import.
    sp = anc16
    sp = (sp | _shl(sp, 8)) & 0x00FF00FF
    sp = (sp | _shl(sp, 4)) & 0x0F0F0F0F
    sp = (sp | _shl(sp, 2)) & 0x33333333
    sp = (sp | _shl(sp, 1)) & 0x55555555
    bef32 = sp * 0x55555555 - sp

    def dynf4(start):
        w0i = _shr(start, 5)
        bit = start & 31
        lo = jnp.where(w0i == 0, w[0],
                       jnp.where(w0i == 1, w[1],
                                 jnp.where(w0i == 2, w[2], w[3])))
        hi = jnp.where(w0i == 0, w[1],
                       jnp.where(w0i == 1, w[2], w[3]))
        lo_part = _shr(lo, bit)
        hi_part = jnp.where(bit == 0, 0, _shl(hi, (32 - bit) & 31))
        return (lo_part | hi_part) & 0xF

    # Weight magic (exact floor((64*idx+c)/d) multiply-shift): the
    # 3-bit vs 4-bit variant choice is per BLOCK (ns1), so hoist the
    # (cadd, mul, shift) triple out of the pixel loop — one multiply
    # per pixel instead of two.
    wm_c = jnp.where(ns1, 7, 3)
    wm_mul = jnp.where(ns1, 34953, 9363)
    wm_sh = jnp.where(ns1, 19, 16)
    # d-form interpolation, hoisted per block per subset:
    #   (64-w)*e0 + w*e1 + 32  ==  (e0<<6) + w*(e1-e0) + 32
    # bit-identical in exact i32 arithmetic (deltas may be negative).
    ibase = {}
    idlt = {}
    for c in "rgb":
        for s in range(2):
            e0, e1 = final[f"{c}{2 * s}"], final[f"{c}{2 * s + 1}"]
            ibase[f"{c}{s}"] = _shl(e0, 6) + 32
            idlt[f"{c}{s}"] = e1 - e0

    for i in range(16):
        before = _shr(bef32, 2 * i) & 3
        is_anchor = (_shr(anc16, i) & 1) != 0
        idx2 = dynf4(82 + 3 * i - before) & jnp.where(is_anchor, 3, 7)
        idx1 = sfield(_OFF_1[i], 4) & (7 if i == 0 else 15)
        idx = jnp.where(ns1, idx1, idx2)
        wgt = _shr((_shl(idx, 6) + wm_c) * wm_mul, wm_sh)
        subset1 = (_shr(sub16, i) & 1) != 0
        sub_hi = ~ns1 & subset1
        vals = []
        for ci, c in enumerate("rgb"):
            base = jnp.where(sub_hi, ibase[f"{c}1"], ibase[f"{c}0"])
            dlt = jnp.where(sub_hi, idlt[f"{c}1"], idlt[f"{c}0"])
            v = (base + wgt * dlt) >> 6
            if signed:
                scaled = jnp.where(v < 0, -lax.shift_right_arithmetic(
                    -v * 31, 5), lax.shift_right_arithmetic(v * 31, 5))
                v = jnp.where(scaled < 0, (-scaled) | 0x8000, scaled)
            else:
                v = _shr(v * 31, 6)
            vals.append(v)
        # Packed FLOAT_RGBX16 payload: R|G<<16, B|X<<16 with X = 0
        # (both u16 patterns; values verified < 2^16 by goldens/fuzz).
        out_ref[2 * i] = vals[0] | _shl(vals[1], 16)
        out_ref[2 * i + 1] = vals[2]

    mm = jnp.broadcast_to(scal_ref[0], mode.shape)
    bit = jnp.clip(mode_raw, 0, 31)
    valid = (mode_raw >= 0) & ((_shr(mm, bit) & 1) != 0)
    valid_ref[...] = valid.astype(jnp.int32)


_KERNELS = {signed: functools.partial(_bc6h_kernel, signed=signed)
            for signed in (False, True)}


def decode_bptc_float_planar(words_planar, mode_mask: int = _FULL,
                             flags: int = 0, *, signed: bool = False,
                             interpret: bool = False):
    """BC6H decode, planar: (4, N) words -> ((32, N) int32 packed
    FLOAT_RGBX16 payload — rows 2i = R|G<<16, 2i+1 = B|X<<16 — plus
    (N,) bool valid)."""
    return planar_call(_KERNELS[signed], words_planar, mode_mask, flags,
                       32, interpret=interpret)


def decode_bptc_float_packed(words, mode_mask: int = _FULL, flags: int = 0,
                             *, signed: bool = False, **kw):
    """(N, 4) int32 -> ((N, 32) int32 packed FLOAT_RGBX16 payload
    words, (N,) bool): the layout of the engine table's p16x4 kind."""
    out, valid = decode_bptc_float_planar(words.T, mode_mask, flags,
                                          signed=signed, **kw)
    return out.T, valid
