"""Device-side (jnp) pixel-format conversion kernels.

Device-resident mirror of the host conversion engine (detex_tpu/convert.py;
reference convert.c:31-751).  The host engine stays the parity oracle —
every kernel here is tested bit-exact against it — while this module
lets the texture engine run decode -> convert -> assemble as ONE jitted
device computation with no host round-trip (reference call stack
texture.c:55-70 -> convert.c:1082-1166, fused).

Pixel representation on device: a (n_pixels, lanes) unsigned-integer
array per format — uint8 lanes for 8-bit formats, uint16 lanes for
16-bit integer *and* half-float formats (half is carried as bits), and
uint32 lanes for 32-bit float formats (carried as bits; kernels bitcast
to f32 internally).  Carrying floats as bits keeps every conversion
bit-exact under XLA (no NaN canonicalization, no x64 dependence).

Exact-rounding notes:
  * f32<->f16 reproduce James Tursa's integer routines
    (half-float.c:102-267) directly on the bit patterns.
  * normalized float->u16 is FE_DOWNWARD lrintf(clamp01(f)*65535+0.5)
    (half-float.c:304-322).  The device path uses no float64 (x64 is
    off) and XLA has no directed rounding, so `quantize_u16_downward` computes the exact result in
    32-bit limb integer arithmetic: the clamped f32 is decomposed into
    (mantissa, exponent), the product m*65535 (< 2^41) is held in two
    uint32 limbs, truncated to 24 significant bits (round-toward -inf
    for positives == truncation), and floor(t + 0.5) is a limb shift.
  * The HDR gamma==1 range mapping runs under FE_DOWNWARD in the
    reference (hdr.c:124, 174).  `down_sub`/`down_mul` emulate one
    downward-rounded f32 op each via TwoSum / Dekker two-product
    residuals: compute round-to-nearest, recover the exact residual,
    and step one ulp down when the residual is negative.  Caveat: XLA
    backends flush f32 denormals (FTZ/DAZ), so the residual recovery
    is exact only for normal-range inputs; denormal HDR inputs behave
    as flushed-to-zero — which is also what the actual compiled
    reference does (-Ofast/-ffast-math links crtfastmath.o and sets
    FTZ+DAZ, Makefile:16).  The bit-level paths (clamp01, the u16
    quantizer, f16<->f32) are exact for ALL inputs incl. denormals.
  * The HDR gamma!=1 half path uses glibc powf through a 65536-entry
    gamma-corrected table (hdr.c:46-60); since the whole half->u16 map
    is a pure function of the 16-bit input, the composed output LUT is
    built once on the host with the bit-exact oracle and shipped to
    the device as a u16 gather table.  The f32 gamma!=1 path maps raw
    values against pow-corrected endpoints (hdr.c:188-206) — plain
    FE_TONEAREST f32 arithmetic, native on device.  Every one of the
    73 conversion edges now runs on device for ALL HDR parameters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from detex_tpu import formats as F
from detex_tpu import hdr as hdr_mod
from detex_tpu.convert import TABLE, ConversionError, match_conversion

# ---------------------------------------------------------------------------
# Representation helpers
# ---------------------------------------------------------------------------


def repr_dtype(fmt: int):
    """Device dtype for one component lane of `fmt`."""
    cs = F.component_size(fmt)
    return {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32}[cs]


def repr_lanes(fmt: int) -> int:
    """Number of stored component lanes (incl. X padding lanes)."""
    return F.pixel_size(fmt) // F.component_size(fmt)


def from_bytes(buf: np.ndarray, n_pixels: int, fmt: int) -> np.ndarray:
    """Flat u8 host buffer -> (n_pixels, lanes) typed host array."""
    cs = F.component_size(fmt)
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[cs]
    return np.ascontiguousarray(buf, dtype=np.uint8).view(dt).reshape(
        n_pixels, repr_lanes(fmt))


def to_bytes(arr: np.ndarray) -> np.ndarray:
    """(n, lanes) typed host array -> flat u8 buffer (little-endian)."""
    return np.ascontiguousarray(arr).view(np.uint8).ravel()


# ---------------------------------------------------------------------------
# Bit-exact float primitives on uint32/uint16 bit patterns
# ---------------------------------------------------------------------------


def f32_bits_to_f16_bits(x):
    """u32 f32 bits -> u16 half bits (reference singles2halfp,
    half-float.c:102-180: round-half-up, denormals -> signed zero,
    NaN -> 0xFE00)."""
    x = x.astype(jnp.uint32)
    xs = x & jnp.uint32(0x80000000)
    xe = x & jnp.uint32(0x7F800000)
    xm = x & jnp.uint32(0x007FFFFF)
    hs = xs >> 16
    hes = (xe >> 23).astype(jnp.int32) - 127 + 15
    zero = (x & jnp.uint32(0x7FFFFFFF)) == 0
    denorm = (xe == 0) & ~zero
    inf_nan = xe == jnp.uint32(0x7F800000)
    inf = inf_nan & (xm == 0)
    nan = inf_nan & (xm != 0)
    # Underflow (hes <= 0): shift mantissa right with round bit.
    sh = 14 - hes
    xmu = xm | jnp.uint32(0x00800000)
    shc = jnp.clip(sh, 0, 31).astype(jnp.uint32)
    hm_u = jnp.where(sh > 24, jnp.uint32(0), xmu >> shc)
    sh1 = jnp.clip(sh - 1, 0, 31).astype(jnp.uint32)
    rnd = jnp.where(sh - 1 > 31, jnp.uint32(0), (xmu >> sh1) & 1)
    under_val = hs | jnp.where(sh > 24, jnp.uint32(0), hm_u + rnd)
    # Normal range: truncate to 10 bits then round-half-up via bit 12
    # (carry may overflow into the exponent — intended, Tursa relies
    # on it to round up to the next binade / infinity).
    he = (jnp.clip(hes, 0, 0x1F).astype(jnp.uint32)) << 10
    rounded = hs | he | (xm >> 13)
    rounded = jnp.where((xm & jnp.uint32(0x1000)) != 0, rounded + 1,
                        rounded)
    out = rounded
    out = jnp.where(hes <= 0, under_val, out)
    out = jnp.where(hes >= 0x1F, hs | jnp.uint32(0x7C00), out)
    out = jnp.where(denorm, hs, out)
    out = jnp.where(zero, x >> 16, out)
    out = jnp.where(inf, hs | jnp.uint32(0x7C00), out)
    out = jnp.where(nan, jnp.uint32(0xFE00), out)
    return out.astype(jnp.uint16)


def f16_bits_to_f32_bits(h):
    """u16 half bits -> u32 f32 bits (reference halfp2singles,
    half-float.c:197-267; NaN canonicalized to 0xFFC00000)."""
    h = h.astype(jnp.uint32)
    hs = h & jnp.uint32(0x8000)
    he = h & jnp.uint32(0x7C00)
    hm = h & jnp.uint32(0x03FF)
    zero = (h & jnp.uint32(0x7FFF)) == 0
    denorm = (he == 0) & ~zero
    inf_nan = he == jnp.uint32(0x7C00)
    inf = inf_nan & (hm == 0)
    nan = inf_nan & (hm != 0)
    # Denormal: normalize mantissa (at most 10 shifts; unrolled, the
    # loop in halfp2singles:222-227).
    hmd = hm
    e = jnp.full(h.shape, -1, jnp.int32)
    for _ in range(11):
        not_done = (hmd & jnp.uint32(0x0400)) == 0
        hmd = jnp.where(not_done, hmd << 1, hmd)
        e = jnp.where(not_done, e + 1, e)
    xes_d = (-15 + 127 - e).astype(jnp.uint32)
    den_val = (hs << 16) | (xes_d << 23) | ((hmd & jnp.uint32(0x03FF)) << 13)
    xes = ((he >> 10).astype(jnp.int32) - 15 + 127).astype(jnp.uint32)
    out = (hs << 16) | (xes << 23) | (hm << 13)
    out = jnp.where(denorm, den_val, out)
    out = jnp.where(zero, h << 16, out)
    out = jnp.where(inf, (hs << 16) | jnp.uint32(0x7F800000), out)
    out = jnp.where(nan, jnp.uint32(0xFFC00000), out)
    return out


def _bitlen_u32(v):
    """Bit length of a uint32 (0 -> 0), unrolled binary search."""
    v = v.astype(jnp.uint32)
    k = jnp.zeros(v.shape, jnp.int32)
    for s in (16, 8, 4, 2, 1):
        big = v >= (jnp.uint32(1) << s)
        k = k + jnp.where(big, s, 0)
        v = jnp.where(big, v >> s, v)
    return k + jnp.where(v > 0, 1, 0)


def clamp01_f32_bits(b):
    """detexClamp0To1 on f32 bits: NaN passes through (both compares
    false), exactly like the C macro.  Implemented as bit-pattern
    compares, NOT float compares: XLA backends flush denormals
    (FTZ/DAZ), so `x < 0` would be false for negative denormals and
    the clamp would diverge from the host oracle on them."""
    b = b.astype(jnp.uint32)
    mag = b & jnp.uint32(0x7FFFFFFF)
    nan = mag > jnp.uint32(0x7F800000)
    neg = ((b >> 31) != 0) & (mag != 0) & ~nan
    gt1 = ((b >> 31) == 0) & (mag > jnp.uint32(0x3F800000)) & ~nan
    out = jnp.where(neg, jnp.uint32(0), b)
    return jnp.where(gt1, jnp.uint32(0x3F800000), out)


def quantize_u16_downward(b):
    """Exact FE_DOWNWARD lrintf(c*65535.0f + 0.5f) for clamped-[0,1]
    f32 bits `b` (half-float.c:306-311), in pure u32 limb arithmetic.

    Derivation: c = M * 2^(E-150) with M < 2^24 (hidden bit folded in,
    E = max(exp_bits, 1)).  P = M*65535 < 2^41 is the exact product
    held as hi*2^16 + lo limbs.  down32(c*65535) truncates P to 24
    significant bits (positive => toward -inf == truncation).  Both
    the +0.5 add and the final lrintf floor reduce to
    floor(P_t*2^-s + 1/2) = (P_t + 2^(s-1)) >> s with s = 150-E >= 23,
    which only touches the hi limb.  NaN -> 0 (lrintf(NaN) -> INT_MIN
    -> uint16 0, matching the host oracle)."""
    b = b.astype(jnp.uint32)
    e = ((b >> 23) & 0xFF).astype(jnp.int32)
    m = (b & jnp.uint32(0x7FFFFF))
    M = jnp.where(e > 0, m | jnp.uint32(0x800000), m)
    E = jnp.maximum(e, 1)
    mh = M >> 16
    ml = M & jnp.uint32(0xFFFF)
    A = mh * jnp.uint32(65535)
    B = ml * jnp.uint32(65535)
    hi = A + (B >> 16)                      # P = hi*2^16 + lo, hi < 2^25
    lo = B & jnp.uint32(0xFFFF)
    k = jnp.where(hi > 0, _bitlen_u32(hi) + 16, _bitlen_u32(lo))
    sh = jnp.maximum(k - 24, 0)             # <= 17
    lo_sh = jnp.minimum(sh, 16).astype(jnp.uint32)
    hi_sh = jnp.maximum(sh - 16, 0).astype(jnp.uint32)
    hi_t = (hi >> hi_sh) << hi_sh
    s = (150 - E)                           # >= 23 for c in [0,1]
    add = jnp.uint32(1) << jnp.clip(s - 17, 0, 31).astype(jnp.uint32)
    res = (hi_t + add) >> jnp.clip(s - 16, 0, 31).astype(jnp.uint32)
    res = jnp.where(s >= 42, jnp.uint32(0), res)
    nan = (b & jnp.uint32(0x7FFFFFFF)) > jnp.uint32(0x7F800000)
    return jnp.where(nan, jnp.uint32(0), res).astype(jnp.uint16)


# --- Directed-rounding f32 ops via exact residuals -------------------------


def _nextbelow_f32_bits(bits):
    """Largest f32 strictly below the (finite) value with bit pattern
    `bits`; +-0 -> -denorm_min, matching nextafterf(x, -inf)."""
    mag0 = (bits & jnp.uint32(0x7FFFFFFF)) == 0
    neg = (bits & jnp.uint32(0x80000000)) != 0
    stepped = jnp.where(neg, bits + 1, bits - 1)
    return jnp.where(mag0, jnp.uint32(0x80000001), stepped)


def _fix_pos_overflow(res, a, b):
    """FE_DOWNWARD positive overflow from finite inputs yields
    +FLT_MAX, not +inf (the TwoSum/Dekker residual is NaN there, so
    the step-down test cannot fire; ADVICE r2)."""
    finite_in = jnp.isfinite(a) & jnp.isfinite(b)
    pos_inf = res == jnp.float32(np.inf)
    return jnp.where(finite_in & pos_inf,
                     jnp.float32(np.finfo(np.float32).max), res)


def down_sub(a, b):
    """f32 a - b rounded toward -inf (one FE_DOWNWARD subtraction).
    TwoSum gives the exact residual of the round-to-nearest result;
    a negative residual means RN rounded up -> step one ulp down."""
    c = -b
    s = a + c
    bv = s - a
    err = (a - (s - bv)) + (c - bv)
    sbits = jax.lax.bitcast_convert_type(s, jnp.uint32)
    down = jax.lax.bitcast_convert_type(_nextbelow_f32_bits(sbits),
                                        jnp.float32)
    return _fix_pos_overflow(jnp.where(err < 0, down, s), a, b)


def _split_f32(x):
    """Dekker split: x == hi + lo with 12-bit halves, exact in RN."""
    c = x * jnp.float32(4097.0)
    hi = c - (c - x)
    return hi, x - hi


def down_mul(a, b):
    """f32 a * b rounded toward -inf (one FE_DOWNWARD multiply),
    via Dekker two-product residual."""
    p = a * b
    ah, al = _split_f32(a)
    bh, bl = _split_f32(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    pbits = jax.lax.bitcast_convert_type(p, jnp.uint32)
    down = jax.lax.bitcast_convert_type(_nextbelow_f32_bits(pbits),
                                        jnp.float32)
    return _fix_pos_overflow(jnp.where(err < 0, down, p), a, b)


# ---------------------------------------------------------------------------
# HDR mapping (device): gamma==1 analytic; gamma!=1 via the 65536-entry
# device-resident gamma LUT gather further below
# ---------------------------------------------------------------------------


def _hdr_map_gamma1_bits(fbits, rmin: float, rmax: float):
    """Gamma-1 range map under FE_DOWNWARD on f32 bits
    (hdr.c:121-141, 171-186) -> clamped [0,1] f32 bits.  The two
    scalar prefactors are computed on the host with the oracle's
    float64 emulation (they depend only on the HDR params)."""
    if rmin == 0.0 and rmax == 1.0:
        return clamp01_f32_bits(fbits)
    denom = np.float32(hdr_mod._down_sub_f32(np.float32(rmax),
                                             np.float32(rmin)))
    factor = hdr_mod._down_recip_f32(denom)
    fbits = fbits.astype(jnp.uint32)
    f = jax.lax.bitcast_convert_type(fbits, jnp.float32)
    t = down_sub(f, jnp.float32(rmin))
    u = down_mul(t, jnp.float32(factor))
    out = clamp01_f32_bits(jax.lax.bitcast_convert_type(u, jnp.uint32))
    # NaN inputs: the host's x87/SSE arithmetic preserves the payload
    # and sets the quiet bit (sNaN -> qNaN); XLA canonicalizes NaNs,
    # so route them around the arithmetic explicitly.
    nan_in = (fbits & jnp.uint32(0x7FFFFFFF)) > jnp.uint32(0x7F800000)
    return jnp.where(nan_in, fbits | jnp.uint32(0x00400000), out)


# ---------------------------------------------------------------------------
# Device conversion kernels (one per host edge; same (src,dst) keys)
# ---------------------------------------------------------------------------


def _k_noop(a):
    return a


def _k_swap_rb(a):
    return a[:, jnp.array([2, 1, 0, 3])]


def _k_rgb8_to_bgrx8(a):
    n = a.shape[0]
    ff = jnp.full((n, 1), 0xFF, jnp.uint8)
    return jnp.concatenate([a[:, 2:3], a[:, 1:2], a[:, 0:1], ff], axis=1)


def _k_offset(a):
    # uint add wraps: +128 (u8) / +32768 (u16), convert.c:783-790.
    half = np.array(1, a.dtype) << (a.dtype.itemsize * 8 - 1)
    return a + half


def _k_take(dst_c):
    return lambda a: a[:, :dst_c]


def _k_expand_u8(src_c):
    def f(a):
        n = a.shape[0]
        pad = jnp.zeros((n, 3 - src_c), jnp.uint8)
        ff = jnp.full((n, 1), 0xFF, jnp.uint8)
        return jnp.concatenate([a, pad, ff], axis=1)
    return f


def _k_u16_to_u8(alpha_ff=False):
    def f(a):
        out = (((a.astype(jnp.uint32) + 127) * 255) // 65535) \
            .astype(jnp.uint8)
        if alpha_ff:
            out = out.at[:, 3].set(jnp.uint8(0xFF))
        return out
    return f


def _k_u8_to_u16(alpha_ffff=False):
    def f(a):
        out = ((a.astype(jnp.uint32) * 65535) // 255).astype(jnp.uint16)
        if alpha_ffff:
            out = out.at[:, 3].set(jnp.uint16(0xFFFF))
        return out
    return f


def _k_f32_to_f16(a):
    return f32_bits_to_f16_bits(a)


def _k_f16_to_f32(a):
    return f16_bits_to_f32_bits(a)


def _k_f32_to_u16(a):
    return quantize_u16_downward(clamp01_f32_bits(a))


def _k_u16_to_f16(rgbx_signed_quirk=False):
    def f(a):
        if rgbx_signed_quirk:
            # convert.c:564-566 reads the components as signed int16;
            # the X lane becomes f16(1.0).
            v = jax.lax.bitcast_convert_type(a, jnp.int16) \
                .astype(jnp.float32) * jnp.float32(1 / 65535)
            v = v.at[:, 3].set(jnp.float32(1.0))
        else:
            v = a.astype(jnp.float32) * jnp.float32(1 / 65535)
        return f32_bits_to_f16_bits(
            jax.lax.bitcast_convert_type(v, jnp.uint32))
    return f


def _k_f16_to_u16(a):
    return quantize_u16_downward(
        clamp01_f32_bits(f16_bits_to_f32_bits(a)))


def _k_rgb16_to_rgbx16(a):
    n = a.shape[0]
    one = jnp.full((n, 1), 0x3C00, jnp.uint16)  # f16(1.0)
    return jnp.concatenate([a, one], axis=1)


def _k_rgb32_to_rgbx32(a):
    n = a.shape[0]
    one = jnp.full((n, 1), 0x3F800000, jnp.uint32)  # f32(1.0) bits
    return jnp.concatenate([a, one], axis=1)


@functools.lru_cache(maxsize=8)
def _gamma_u16_lut(gamma: float, rmin: float, rmax: float) -> np.ndarray:
    """Full 65536-entry f16-bits -> u16 output table for gamma != 1.

    The reference's special-gamma half path is a pure function of the
    16-bit input and the HDR params (a gamma-corrected LUT feeding a
    range map, hdr.c:46-60, 143-166); precompute the WHOLE composition
    on the host with the bit-exact oracle and gather on device."""
    bits = np.arange(65536, dtype=np.uint16)
    return np.asarray(hdr_mod.hdr_half_to_u16(
        bits, hdr_mod.HDRParams(gamma, rmin, rmax)))


class _HDREdge:
    """HDR edges depend on runtime HDR params, resolved at trace time.

    gamma == 1: FE_DOWNWARD range map emulated in limb arithmetic.
    gamma != 1, f16 -> u16: device-resident 65536-entry u16 LUT gather
      (the reference's gamma-corrected table composed with the range
      map + quantizer, hdr.c:46-60, 143-166).
    gamma != 1, f32 -> f32: the reference maps the RAW value against
      pow-corrected range endpoints at FE_TONEAREST (hdr.c:188-206) —
      plain f32 arithmetic, native on device."""

    def __init__(self, kind):
        self.kind = kind  # "f16_to_u16" | "f32_to_f32"

    def supported(self) -> bool:
        return True

    def __call__(self, a):
        p = hdr_mod.get_hdr_parameters()
        if p.gamma != 1.0:
            if self.kind == "f16_to_u16":
                lut = jnp.asarray(_gamma_u16_lut(p.gamma, p.range_min,
                                                 p.range_max))
                return lut[a.astype(jnp.int32)]
            return _hdr_map_gamma_f32_bits(a, p)
        if self.kind == "f16_to_u16":
            fb = f16_bits_to_f32_bits(a)
            c = _hdr_map_gamma1_bits(fb, p.range_min, p.range_max)
            return quantize_u16_downward(c)
        c = _hdr_map_gamma1_bits(a, p.range_min, p.range_max)
        return c  # f32 bits


def _hdr_map_gamma_f32_bits(fbits, p):
    """Special-gamma f32 map (hdr.c:188-206): clamp01((f - cmin) *
    factor) with cmin/cmax = signed powf of the range params, all at
    FE_TONEAREST — two native f32 ops.  NaNs are routed around the
    arithmetic (XLA canonicalizes payloads; the host quiets them)."""
    inv_g = float(np.float32(1.0) / np.float32(p.gamma))
    cmin = np.float32(np.asarray(hdr_mod._signed_powf(
        np.float32(p.range_min), inv_g)).item())
    cmax = np.float32(np.asarray(hdr_mod._signed_powf(
        np.float32(p.range_max), inv_g)).item())
    factor = np.float32(1.0) / np.float32(cmax - cmin)
    fbits = fbits.astype(jnp.uint32)
    f = jax.lax.bitcast_convert_type(fbits, jnp.float32)
    u = (f - jnp.float32(cmin)) * jnp.float32(factor)
    out = clamp01_f32_bits(jax.lax.bitcast_convert_type(u, jnp.uint32))
    nan_in = (fbits & jnp.uint32(0x7FFFFFFF)) > jnp.uint32(0x7F800000)
    return jnp.where(nan_in, fbits | jnp.uint32(0x00400000), out)


_hdr_f16_u16 = _HDREdge("f16_to_u16")
_hdr_f32_f32 = _HDREdge("f32_to_f32")

# (src, dst) -> device kernel, mirroring every host edge in
# convert.TABLE (convert.c:765-864).  Path *identity* comes from the
# host match_conversion, so rounding-path parity is automatic.
_DEV = {}


def _dev(src, dst, fn):
    _DEV[(src, dst)] = fn


_dev(F.RGBX8, F.RGBA8, _k_noop)
_dev(F.RGBA8, F.RGBX8, _k_noop)
_dev(F.BGRX8, F.BGRA8, _k_noop)
_dev(F.BGRA8, F.BGRX8, _k_noop)
_dev(F.RGBX8, F.BGRX8, _k_swap_rb)
_dev(F.BGRX8, F.RGBX8, _k_swap_rb)
_dev(F.RGBA8, F.BGRA8, _k_swap_rb)
_dev(F.BGRA8, F.RGBA8, _k_swap_rb)
_dev(F.FLOAT_RGBX16, F.FLOAT_BGRX16, _k_swap_rb)
_dev(F.FLOAT_BGRX16, F.FLOAT_RGBX16, _k_swap_rb)
_dev(F.RGB8, F.BGRX8, _k_rgb8_to_bgrx8)
_dev(F.R8, F.SIGNED_R8, _k_offset)
_dev(F.RG8, F.SIGNED_RG8, _k_offset)
_dev(F.SIGNED_R8, F.R8, _k_offset)
_dev(F.SIGNED_RG8, F.RG8, _k_offset)
_dev(F.R16, F.SIGNED_R16, _k_offset)
_dev(F.RG16, F.SIGNED_RG16, _k_offset)
_dev(F.SIGNED_R16, F.R16, _k_offset)
_dev(F.SIGNED_RG16, F.RG16, _k_offset)
_dev(F.RGBA8, F.R8, _k_take(1))
_dev(F.RGBA8, F.RG8, _k_take(2))
_dev(F.RGB8, F.R8, _k_take(1))
_dev(F.RGB8, F.RG8, _k_take(2))
_dev(F.R8, F.RGBX8, _k_expand_u8(1))
_dev(F.RG8, F.RGBX8, _k_expand_u8(2))
_dev(F.R16, F.R8, _k_u16_to_u8())
_dev(F.RG16, F.RG8, _k_u16_to_u8())
_dev(F.RGB16, F.RGB8, _k_u16_to_u8())
_dev(F.RGBX16, F.RGBX8, _k_u16_to_u8(alpha_ff=True))
_dev(F.RGBA16, F.RGBA8, _k_u16_to_u8())
_dev(F.R8, F.R16, _k_u8_to_u16())
_dev(F.RG8, F.RG16, _k_u8_to_u16())
_dev(F.RGB8, F.RGB16, _k_u8_to_u16())
_dev(F.RGBX8, F.RGBX16, _k_u8_to_u16(alpha_ffff=True))
_dev(F.RGBA8, F.RGBA16, _k_u8_to_u16())
_dev(F.R16, F.FLOAT_R16, _k_u16_to_f16())
_dev(F.RG16, F.FLOAT_RG16, _k_u16_to_f16())
_dev(F.RGB16, F.FLOAT_RGB16, _k_u16_to_f16())
_dev(F.RGBX16, F.FLOAT_RGBX16, _k_u16_to_f16(rgbx_signed_quirk=True))
_dev(F.FLOAT_R16, F.R16, _k_f16_to_u16)
_dev(F.FLOAT_RG16, F.RG16, _k_f16_to_u16)
_dev(F.FLOAT_RGB16, F.RGB16, _k_f16_to_u16)
_dev(F.FLOAT_RGBX16, F.RGBX16, _k_f16_to_u16)
_dev(F.FLOAT_RGBA16, F.RGBA16, _k_f16_to_u16)
_dev(F.FLOAT_R16_HDR, F.R16, _hdr_f16_u16)
_dev(F.FLOAT_RG16_HDR, F.RG16, _hdr_f16_u16)
_dev(F.FLOAT_RGBX16_HDR, F.RGBX16, _hdr_f16_u16)
_dev(F.FLOAT_R32, F.FLOAT_R16, _k_f32_to_f16)
_dev(F.FLOAT_RG32, F.FLOAT_RG16, _k_f32_to_f16)
_dev(F.FLOAT_RGB32, F.FLOAT_RGB16, _k_f32_to_f16)
_dev(F.FLOAT_RGBX32, F.FLOAT_RGBX16, _k_f32_to_f16)
_dev(F.FLOAT_R32, F.R16, _k_f32_to_u16)
_dev(F.FLOAT_RG32, F.RG16, _k_f32_to_u16)
_dev(F.FLOAT_RGB32, F.RGB16, _k_f32_to_u16)
_dev(F.FLOAT_RGBX32, F.RGBX16, _k_f32_to_u16)
_dev(F.FLOAT_R16, F.FLOAT_R32, _k_f16_to_f32)
_dev(F.FLOAT_RG16, F.FLOAT_RG32, _k_f16_to_f32)
_dev(F.FLOAT_RGB16, F.FLOAT_RGB32, _k_f16_to_f32)
_dev(F.FLOAT_RGBX16, F.FLOAT_RGBX32, _k_f16_to_f32)
_dev(F.FLOAT_R32_HDR, F.FLOAT_R32, _hdr_f32_f32)
_dev(F.FLOAT_RG32_HDR, F.FLOAT_RG32, _hdr_f32_f32)
_dev(F.FLOAT_RGB32_HDR, F.FLOAT_RGB32, _hdr_f32_f32)
_dev(F.FLOAT_RGBX32_HDR, F.FLOAT_RGBX32, _hdr_f32_f32)
_dev(F.RGB8, F.RGBX8, _k_expand_u8(3))
_dev(F.RGBX8, F.RGB8, _k_take(3))
_dev(F.FLOAT_RGB16, F.FLOAT_RGBX16, _k_rgb16_to_rgbx16)
_dev(F.FLOAT_RGBX16, F.FLOAT_RGB16, _k_take(3))
_dev(F.FLOAT_RGB16_HDR, F.FLOAT_RGBX16_HDR, _k_rgb16_to_rgbx16)
_dev(F.FLOAT_RGBX16_HDR, F.FLOAT_RGB16_HDR, _k_take(3))
_dev(F.FLOAT_RGB32, F.FLOAT_RGBX32, _k_rgb32_to_rgbx32)
_dev(F.FLOAT_RGBX32, F.FLOAT_RGB32, _k_take(3))
_dev(F.FLOAT_RGB32_HDR, F.FLOAT_RGBX32_HDR, _k_rgb32_to_rgbx32)
_dev(F.FLOAT_RGBX32_HDR, F.FLOAT_RGB32_HDR, _k_take(3))

# Edge-index-aligned view of the device kernels (index into
# convert.TABLE == index here), so the *host* path search decides the
# route and the device executes the identical step sequence.
DEVICE_TABLE = [_DEV.get((s, d)) for (s, d, _) in TABLE]

assert all(k is not None for k in DEVICE_TABLE), \
    "every host conversion edge needs a device mirror"


def path_supported(src_fmt: int, dst_fmt: int) -> bool:
    """True if the conversion path can run fully on device with the
    current HDR parameters."""
    path = match_conversion(src_fmt, dst_fmt)
    if path is None:
        return False
    for step in path:
        k = DEVICE_TABLE[step]
        if isinstance(k, _HDREdge) and not k.supported():
            return False
    return True


def convert_pixels_device(arr, src_fmt: int, dst_fmt: int):
    """Convert a (n, lanes) typed device array between formats.  Must
    be called under jit (or traces eagerly); path identity matches the
    host engine exactly."""
    if src_fmt == dst_fmt:
        return arr
    path = match_conversion(src_fmt, dst_fmt)
    if path is None:
        raise ConversionError(
            f"Unable to find conversion path "
            f"{F.format_name(src_fmt)} -> {F.format_name(dst_fmt)}")
    for step in path:
        arr = DEVICE_TABLE[step](arr)
    return arr


def hdr_params_key() -> tuple:
    """HDR params get baked into traces (the prefactors are trace-time
    constants); any jit cache over conversion paths must key on this."""
    p = hdr_mod.get_hdr_parameters()
    return (p.gamma, p.range_min, p.range_max)


@functools.lru_cache(maxsize=None)
def _jitted_convert(src_fmt: int, dst_fmt: int, _params_key: tuple):
    return jax.jit(lambda a: convert_pixels_device(a, src_fmt, dst_fmt))


def convert_pixels_jax(src: np.ndarray, n_pixels: int, src_fmt: int,
                       dst_fmt: int) -> np.ndarray:
    """Host-convenience wrapper with the same signature/semantics as
    convert.convert_pixels, executed on device.  Used by parity tests."""
    arr = from_bytes(src, n_pixels, src_fmt)
    out = _jitted_convert(src_fmt, dst_fmt, hdr_params_key())(arr)
    return to_bytes(np.asarray(out))
