"""BPTC (BC7) block decoder — batched, branch-free, compute-all-modes.

Batched redesign of the reference per-block decoder
(reference: decompress-bptc.c:354-512).  The reference walks a serial
bit cursor whose positions depend on mode and partition; here every
mode's layout is a *static* table of bit offsets, the anchored index
streams become precomputed (64 partitions x 16 pixels) offset tables,
and each block's pixels are selected from the 8 per-mode decodes by its
actual mode.  No data-dependent control flow anywhere.

Bit-exact semantics reproduced:
  * unary mode prefix; byte0 == 0 -> invalid (decompress-bptc.c:229-237)
  * mode_mask gating and OPAQUE/NON_OPAQUE flags
    (decompress-bptc.c:363-369)
  * endpoint extraction order (component, subset, endpoint)
    (decompress-bptc.c:74-132); p-bit append + left shift + MSB
    replication (decompress-bptc.c:136-180); mode 1 shared p-bits
    (decompress-bptc.c:297-306)
  * anchored index streams: anchor pixels store one less bit
    (decompress-bptc.c:400-480)
  * interpolation ((64-w)*e0 + w*e1 + 32) >> 6 with the aWeight tables
    (decompress-bptc.c:182-193, bptc-tables.c:190-201)
  * mode 4 index-selection bit swaps the color/alpha index streams
    (decompress-bptc.c:381-385, 422-451)
  * rotation swaps A with R/G/B (decompress-bptc.c:497-508)

Input: (N, 4) little-endian int32 words.  Output: ((N, 16) int32 packed
RGBA8, (N,) bool valid).
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from detex_tpu import formats as F
from detex_tpu.ops.bitops import (dyn_field, field_words, has_flag, mask_bit,
                                  pack_rgba8)

_FULL = 0xFFFFFFFF

# Per-mode static layout (decompress-bptc.c:45-71, 195-267).
_NS = [3, 2, 3, 2, 1, 1, 1, 2]          # subsets
_PB = [4, 6, 6, 6, 0, 0, 0, 6]          # partition bits
_RB = [0, 0, 0, 0, 2, 2, 0, 0]          # rotation bits
_ISB = [0, 0, 0, 0, 1, 0, 0, 0]         # index-selection bit (mode 4)
_CP = [4, 6, 5, 7, 5, 7, 7, 5]          # color precision (no p-bit)
_CPP = [5, 7, 5, 8, 5, 7, 8, 6]         # color precision incl. p-bit
_AP = [0, 0, 0, 0, 6, 8, 7, 5]          # alpha precision
_APP = [0, 0, 0, 0, 6, 8, 8, 6]         # alpha precision incl. p-bit
_IB = [3, 3, 2, 2, 2, 2, 4, 2]          # primary index bits
_IB2 = [0, 0, 0, 0, 3, 2, 0, 0]         # secondary index bits
_HAS_PBITS = [1, 1, 0, 1, 0, 0, 1, 1]

_TABLES = dict(np.load(Path(__file__).parent.parent / "data"
                       / "bptc_tables.npz"))
_P2 = _TABLES["P2"].astype(np.int32)            # (64, 16)
_P3 = _TABLES["P3"].astype(np.int32)            # (64, 16)
_ANCHOR2 = _TABLES["anchor2"].astype(np.int32)  # (64,)
_ANCHOR2OF3 = _TABLES["anchor2of3"].astype(np.int32)
_ANCHOR3 = _TABLES["anchor3"].astype(np.int32)
_WEIGHTS = {2: _TABLES["weight2"].astype(np.int32),
            3: _TABLES["weight3"].astype(np.int32),
            4: _TABLES["weight4"].astype(np.int32)}


def _mode_layout(mode: int):
    """Static stream start offsets for one mode."""
    pos = mode + 1                       # unary prefix
    pb_start = pos
    pos += _PB[mode]
    rb_start = pos
    pos += _RB[mode]
    isb_start = pos
    pos += _ISB[mode]
    ep_start = pos
    pos += _CP[mode] * _NS[mode] * 2 * 3
    alpha_start = pos
    pos += _AP[mode] * _NS[mode] * 2
    pbit_start = pos
    pos += (2 if mode == 1 else _NS[mode] * 2) * _HAS_PBITS[mode]
    index_start = pos
    return dict(pb=pb_start, rb=rb_start, isb=isb_start, ep=ep_start,
                alpha=alpha_start, pbit=pbit_start, index=index_start)


def _anchor_tables(mode: int):
    """(64, 16) is_anchor and exclusive anchor counts for one mode."""
    ns = _NS[mode]
    is_anchor = np.zeros((64, 16), dtype=bool)
    is_anchor[:, 0] = True
    if ns == 2:
        is_anchor[np.arange(64), _ANCHOR2] = True
    elif ns == 3:
        is_anchor[np.arange(64), _ANCHOR2OF3] = True
        is_anchor[np.arange(64), _ANCHOR3] = True
    anchors_before = np.cumsum(is_anchor, axis=1) - is_anchor
    return is_anchor, anchors_before.astype(np.int32)


# Precomputed per-mode stream-offset tables: for the primary and
# secondary index streams, (64, 16) within-stream bit offsets and
# (64, 16) per-pixel value masks (anchor pixels store one less bit).
_MODE_STATIC = []
for _m in range(8):
    _lay = _mode_layout(_m)
    _isa, _before = _anchor_tables(_m)
    _ib, _ib2 = _IB[_m], _IB2[_m]
    _prim_off = _ib * np.arange(16)[None, :] - _before
    _prim_mask = np.where(_isa, (1 << (_ib - 1)) - 1, (1 << _ib) - 1)
    if _ib2:
        _sec_off = _ib2 * np.arange(16)[None, :] - _before
        _sec_mask = np.where(_isa, (1 << (_ib2 - 1)) - 1, (1 << _ib2) - 1)
    else:
        _sec_off = _sec_mask = np.zeros((64, 16), np.int32)
    # Secondary stream begins after the primary stream, whose total
    # length is IB*16 - (#anchors); the anchor count per partition is
    # the subset count, identical for every partition of a mode.
    _n_anchors = int(_isa[0].sum())
    _MODE_STATIC.append(dict(
        layout=_lay, prim_off=_prim_off.astype(np.int32),
        prim_mask=_prim_mask.astype(np.int32),
        sec_start=_lay["index"] + _ib * 16 - _n_anchors,
        sec_off=_sec_off.astype(np.int32),
        sec_mask=_sec_mask.astype(np.int32)))


def _extract_mode(words):
    """First set bit of byte 0 = mode; none -> -1
    (decompress-bptc.c:229-237)."""
    b0 = jnp.bitwise_and(words[:, 0], 0xFF)
    mode = jnp.full(b0.shape, -1, jnp.int32)
    for i in range(7, -1, -1):
        mode = jnp.where(jnp.bitwise_and(b0, 1 << i) != 0, i, mode)
    # lowest set bit wins: scan from high to low so low bits overwrite
    return mode


def _dequant(raw, pbit, prec: int, prec_p: int):
    """(value [<<1 | pbit]) << (8-prec_p), MSB-replicated
    (decompress-bptc.c:160-175)."""
    v = raw
    if prec_p > prec:
        v = (v << 1) | pbit
    v = v << (8 - prec_p)
    return v | (v >> prec_p)


def _decode_mode(words, mode: int):
    """Decode every block under one mode; (N, 16, 4) int32 RGBA."""
    st = _MODE_STATIC[mode]
    lay = st["layout"]
    ns = _NS[mode]
    n = words.shape[0]

    psid = (field_words(words, lay["pb"], _PB[mode]) if _PB[mode]
            else jnp.zeros((n,), jnp.int32))
    rot = (field_words(words, lay["rb"], _RB[mode]) if _RB[mode]
           else None)
    isb = (field_words(words, lay["isb"], 1) if _ISB[mode]
           else None)

    # --- endpoints -------------------------------------------------------
    cp = _CP[mode]
    # raw[c][j][k]: component c, subset j, endpoint k
    raw = []
    pos = lay["ep"]
    for c in range(3):
        comp = []
        for j in range(ns):
            pair = []
            for k in range(2):
                pair.append(field_words(words, pos, cp))
                pos += cp
            comp.append(pair)
        raw.append(comp)
    ap = _AP[mode]
    if ap:
        pos = lay["alpha"]
        comp = []
        for j in range(ns):
            pair = []
            for k in range(2):
                pair.append(field_words(words, pos, ap))
                pos += ap
            comp.append(pair)
        raw.append(comp)

    # p-bits (decompress-bptc.c:138-158; mode 1 shared per subset
    # decompress-bptc.c:297-306)
    pbits = None
    if _HAS_PBITS[mode]:
        if mode == 1:
            shared = [field_words(words, lay["pbit"] + i, 1)
                      for i in range(2)]
            pbits = [[shared[j], shared[j]] for j in range(ns)]
        elif mode == 6:
            # Reference quirk: mode 6's p-bits sit at bits 63 and 64,
            # crossing the word boundary, but FullyDecodeEndpoints
            # reads both from `data0 >> 63` (decompress-bptc.c:142-146)
            # so the second p-bit always reads as 0.  Bug-compatible.
            pbits = [[field_words(words, 63, 1),
                      jnp.zeros((n,), jnp.int32)]]
        else:
            pbits = [[field_words(words, lay["pbit"] + j * 2 + k, 1)
                      for k in range(2)] for j in range(ns)]

    # dequantize to 8-bit
    ep = np.empty((4, ns, 2), dtype=object)
    for j in range(ns):
        for k in range(2):
            pb = pbits[j][k] if pbits is not None else 0
            for c in range(3):
                ep[c, j, k] = _dequant(raw[c][j][k], pb, _CP[mode],
                                       _CPP[mode])
            if ap:
                ep[3, j, k] = _dequant(raw[3][j][k], pb, _AP[mode],
                                       _APP[mode])
            else:
                ep[3, j, k] = jnp.full((n,), 0xFF, jnp.int32)
    if mode <= 3:
        for j in range(ns):
            for k in range(2):
                ep[3, j, k] = jnp.full((n,), 0xFF, jnp.int32)

    # --- subset assignment ----------------------------------------------
    if ns == 1:
        subset = jnp.zeros((n, 16), jnp.int32)
    elif ns == 2:
        subset = jnp.asarray(_P2)[psid]
    else:
        subset = jnp.asarray(_P3)[psid]

    # --- index streams ---------------------------------------------------
    prim_off = jnp.asarray(st["prim_off"])[psid] + lay["index"]
    prim_mask = jnp.asarray(st["prim_mask"])[psid]
    prim = jnp.bitwise_and(dyn_field(words, prim_off, _IB[mode]), prim_mask)
    if _IB2[mode]:
        sec_off = jnp.asarray(st["sec_off"])[psid] + st["sec_start"]
        sec_mask = jnp.asarray(st["sec_mask"])[psid]
        sec = jnp.bitwise_and(dyn_field(words, sec_off, _IB2[mode]),
                              sec_mask)
    else:
        sec = None

    # --- per-pixel endpoint select + interpolate ------------------------
    def select_ep(c, k):
        out = ep[c, 0, k][:, None]
        for j in range(1, ns):
            out = jnp.where(subset == j, ep[c, j, k][:, None], out)
        return out

    def interp(e0, e1, idx, bits: int):
        w = jnp.asarray(_WEIGHTS[bits])[idx]
        return (( (64 - w) * e0 + w * e1 + 32) >> 6)

    def full_pixels(color_idx, color_bits, alpha_idx, alpha_bits):
        chans = []
        for c in range(3):
            chans.append(interp(select_ep(c, 0), select_ep(c, 1),
                                color_idx, color_bits))
        chans.append(interp(select_ep(3, 0), select_ep(3, 1),
                            alpha_idx, alpha_bits))
        return chans

    if mode == 4:
        # index_selection_bit swaps streams and widths
        # (decompress-bptc.c:381-385, 422-451)
        r0 = full_pixels(prim, 2, sec, 3)
        r1 = full_pixels(sec, 3, prim, 2)
        isb_m = (isb != 0)[:, None]
        chans = [jnp.where(isb_m, a, b) for a, b in zip(r1, r0)]
    elif _IB2[mode]:
        chans = full_pixels(prim, _IB[mode], sec, _IB2[mode])
    else:
        chans = full_pixels(prim, _IB[mode], prim, _IB[mode])

    r, g, b, a = chans
    if rot is not None:
        rotm = rot[:, None]
        new_r = jnp.where(rotm == 1, a, r)
        new_g = jnp.where(rotm == 2, a, g)
        new_b = jnp.where(rotm == 3, a, b)
        new_a = jnp.where(rotm == 1, r,
                          jnp.where(rotm == 2, g,
                                    jnp.where(rotm == 3, b, a)))
        r, g, b, a = new_r, new_g, new_b, new_a
    return pack_rgba8(r, g, b, a)


def decode_bptc(words, mode_mask: int = _FULL, flags: int = 0):
    """BC7 (reference detexDecompressBlockBPTC, decompress-bptc.c:354-512).
    words: (N, 4) int32."""
    mode = _extract_mode(words)
    pix = _decode_mode(words, 0)
    for m in range(1, 8):
        pix = jnp.where((mode == m)[:, None], _decode_mode(words, m), pix)
    valid = (mode >= 0) & mask_bit(mode_mask, mode)
    valid = valid & ~(has_flag(flags, F.FLAG_OPAQUE_ONLY) & (mode >= 4))
    valid = valid & ~(has_flag(flags, F.FLAG_NON_OPAQUE_ONLY) & (mode < 4))
    return pix, valid
