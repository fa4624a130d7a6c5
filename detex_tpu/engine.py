"""Texture decode engine: batched block decode + conversion + assembly.

Device-resident equivalent of the reference texture engine
(reference: texture.c:27-145).  Where the reference walks blocks one at
a time through a function-pointer table (texture.c:85-96, 115-143), this
engine decodes the *entire* texture as one batched, jitted device
computation, converts pixels, and assembles the linear image with a
reshape/transpose — no per-block loop anywhere.

Layers:
  decode_blocks_device : blocks -> decoder-native device arrays
      (packed RGBA8 pixels for the u32 families; packed PAYLOAD words
      for the p8/p16/... families — see the _DECODERS table, the one
      place that picks each family's device decoder)
  decode_blocks_sharded: the same, sharded over a mesh axis (zero
      collectives)
  decode_blocks        : blocks -> native per-block pixel bytes (host)
  decompress_texture_linear / _tiled : full reference parity incl.
      pixel-format conversion, partial edge blocks, invalid-block
      zero-fill (texture.c:90-93, 125-127)
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from detex_tpu import convert as C
from detex_tpu import convert_device as CD
from detex_tpu import formats as F
from detex_tpu.ops import bc as BCJ
from detex_tpu.ops import bptc_fast as BPJ
from detex_tpu.ops import bptc_float as BFJ
from detex_tpu.ops import eac as EACJ
from detex_tpu.ops import etc as ETCJ
from detex_tpu.ops import rgtc as RGJ
from detex_tpu.ops.bitops import pack_u8x4, pack_u16x2, words_from_bytes
from detex_tpu.ops.pallas import (bptc_float_pallas, bptc_pallas,
                                  etc_eac_pallas)
from detex_tpu.texture import Texture

# Backend that actually executed the most recent
# decompress_texture_linear call ("device" / "jax" / "native") — lets
# callers and benchmarks confirm no silent downgrade happened.
LAST_BACKEND: str = ""

_FULL = 0xFFFFFFFF


def _packed(fn, pack):
    """Per-value jnp decoder -> decoder of packed payload words."""
    def dec(words, mode_mask=_FULL, flags=0):
        vals, valid = fn(words, mode_mask, flags)
        return pack(vals.reshape(vals.shape[0], -1)), valid
    dec.__name__ = dec.__qualname__ = f"{fn.__name__}_packed"
    dec.__module__ = fn.__module__
    return dec


def _gpu_kernel(kernel, fallback):
    """Decoder that lowers to `kernel` (a Pallas kernel compiled for
    the GPU through Triton) on CUDA, and to the jnp `fallback` on every
    other platform.  The choice is made per lowering, so one jitted
    program placed on the CPU still gets the jnp decoder."""
    def dec(words, mode_mask=_FULL, flags=0):
        if isinstance(mode_mask, int):
            mode_mask = np.uint32(mode_mask & _FULL)
        if isinstance(flags, int):
            flags = np.uint32(flags & _FULL)
        return jax.lax.platform_dependent(words, mode_mask, flags,
                                          cuda=kernel, default=fallback)
    dec.gpu_kernel, dec.fallback = kernel, fallback
    return dec


# The device decoder table: compressed-format index -> (decoder, packer
# kind).  It is the one place that picks how a family decodes on the
# device (decode_blocks_device, the fused texture pipelines and the
# control/train steps' BC7 observation decode all read it).  An entry is
# a plain jnp decoder, which XLA fuses with the rest of the pipeline,
# or, where a hand-written kernel beat it end to end on an H100, that
# kernel on the GPU with the jnp decoder elsewhere (_gpu_kernel).
# Packer kinds describe the decoder's output -> byte-layout mapping:
#   u32  : (N, 16) packed 32-bit RGBA8 pixels
#   p8   : (N, k) words of 4 packed u8 pixels    (R8)
#   p8x2 : (N, k) words of 2 packed RG8 pixels
#   p16  : (N, k) words of 2 packed u16 values   ((SIGNED_)R16)
#   p16x2: (N, 16) words of one R|G<<16 pixel    ((SIGNED_)RG16)
#   p16x4: (N, 32) word pairs R|G<<16, B|X<<16   (FLOAT_RGBX16)
# All kinds are little-endian byte streams equal to the reference
# decoders' pixel_buffer layouts (detex.h:879-930 pixel sizes) — the
# decoders emit the TRUE payload, with no write amplification.
_DECODERS = {
    F.IDX_BC1: (BCJ.decode_bc1, "u32"),
    F.IDX_BC1A: (BCJ.decode_bc1a, "u32"),
    F.IDX_BC2: (BCJ.decode_bc2, "u32"),
    F.IDX_BC3: (BCJ.decode_bc3, "u32"),
    F.IDX_RGTC1: (_packed(RGJ.decode_rgtc1, pack_u8x4), "p8"),
    F.IDX_SIGNED_RGTC1: (_packed(RGJ.decode_signed_rgtc1, pack_u16x2),
                         "p16"),
    F.IDX_RGTC2: (_packed(RGJ.decode_rgtc2, pack_u8x4), "p8x2"),
    F.IDX_SIGNED_RGTC2: (_packed(RGJ.decode_signed_rgtc2, pack_u16x2),
                         "p16x2"),
    F.IDX_BPTC_FLOAT: (_gpu_kernel(
        bptc_float_pallas.decode_bptc_float_packed,
        _packed(BFJ.decode_bptc_float, pack_u16x2)), "p16x4"),
    F.IDX_BPTC_SIGNED_FLOAT: (_gpu_kernel(
        functools.partial(bptc_float_pallas.decode_bptc_float_packed,
                          signed=True),
        _packed(BFJ.decode_bptc_signed_float, pack_u16x2)), "p16x4"),
    F.IDX_BPTC: (_gpu_kernel(bptc_pallas.decode_bptc,
                             BPJ.decode_bptc_fast), "u32"),
    F.IDX_ETC1: (ETCJ.decode_etc1, "u32"),
    F.IDX_ETC2: (_gpu_kernel(etc_eac_pallas.decode_etc2,
                             ETCJ.decode_etc2), "u32"),
    F.IDX_ETC2_PUNCHTHROUGH: (_gpu_kernel(
        etc_eac_pallas.decode_etc2_punchthrough,
        ETCJ.decode_etc2_punchthrough), "u32"),
    F.IDX_ETC2_EAC: (_gpu_kernel(etc_eac_pallas.decode_etc2_eac,
                                 ETCJ.decode_etc2_eac), "u32"),
    F.IDX_EAC_R11: (_packed(EACJ.decode_eac_r11, pack_u16x2), "p16"),
    F.IDX_EAC_SIGNED_R11: (_packed(EACJ.decode_eac_signed_r11, pack_u16x2),
                           "p16"),
    F.IDX_EAC_RG11: (_packed(EACJ.decode_eac_rg11, pack_u16x2), "p16x2"),
    F.IDX_EAC_SIGNED_RG11: (
        _packed(EACJ.decode_eac_signed_rg11, pack_u16x2), "p16x2"),
}


def device_decoder(tex_fmt: int):
    """The table's device decoder for a compressed format:
    (N, k) int32 words -> (payload words, (N,) bool valid)."""
    idx = F.compressed_index(tex_fmt)
    if idx not in _DECODERS:
        raise ValueError(f"not a compressed format: {tex_fmt:#x}")
    return _DECODERS[idx][0]


def _name(fn) -> str:
    if isinstance(fn, functools.partial):
        args = ", ".join(f"{k}={v}" for k, v in fn.keywords.items())
        return f"{_name(fn.func)}({args})"
    return f"{fn.__module__}.{fn.__qualname__}"


def decoder_name(tex_fmt: int, platform: str = None) -> str:
    """What the table runs for `tex_fmt` on `platform` (default: JAX's
    default backend): "triton:<kernel>" or "xla:<jnp decoder>"."""
    fn = device_decoder(tex_fmt)
    platform = platform or jax.default_backend()
    if hasattr(fn, "gpu_kernel"):
        if platform == "gpu":
            return f"triton:{_name(fn.gpu_kernel)}"
        fn = fn.fallback
    return f"xla:{_name(fn)}"


# compressed-format index -> native-library family name (detex_tpu.native)
_NATIVE_FAMILY = {
    F.IDX_BC1: "BC1", F.IDX_BC1A: "BC1A", F.IDX_BC2: "BC2",
    F.IDX_BC3: "BC3", F.IDX_RGTC1: "RGTC1",
    F.IDX_SIGNED_RGTC1: "SIGNED_RGTC1", F.IDX_RGTC2: "RGTC2",
    F.IDX_SIGNED_RGTC2: "SIGNED_RGTC2", F.IDX_BPTC_FLOAT: "BPTC_FLOAT",
    F.IDX_BPTC_SIGNED_FLOAT: "BPTC_SIGNED_FLOAT", F.IDX_BPTC: "BPTC",
    F.IDX_ETC1: "ETC1", F.IDX_ETC2: "ETC2",
    F.IDX_ETC2_PUNCHTHROUGH: "ETC2_PUNCHTHROUGH",
    F.IDX_ETC2_EAC: "ETC2_EAC", F.IDX_EAC_R11: "EAC_R11",
    F.IDX_EAC_SIGNED_R11: "EAC_SIGNED_R11", F.IDX_EAC_RG11: "EAC_RG11",
    F.IDX_EAC_SIGNED_RG11: "EAC_SIGNED_RG11",
}


@functools.lru_cache(maxsize=None)
def _jitted_decoder(idx: int):
    fn, _ = _DECODERS[idx]
    return jax.jit(fn)


def decode_blocks_device(tex_fmt: int, words, mode_mask=0xFFFFFFFF,
                         flags=0):
    """Decode a (N, k) int32 word batch on the device.  Returns the
    decoder's native arrays (pixels, valid) without host transfer."""
    idx = F.compressed_index(tex_fmt)
    if idx not in _DECODERS:
        raise ValueError(f"not a compressed format: {tex_fmt:#x}")
    return _jitted_decoder(idx)(words, np.uint32(mode_mask),
                                np.uint32(flags))


@functools.lru_cache(maxsize=None)
def _sharded_decoder(idx: int, mesh_key, axis: str):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    mesh = _MESHES[mesh_key]
    fn, _ = _DECODERS[idx]

    def local(words, mode_mask, flags):
        return fn(words, mode_mask[0], flags[0])

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=(P(axis), P(axis)))

    def call(words, mode_mask, flags):
        return sharded(words, jnp.asarray([mode_mask], jnp.uint32),
                       jnp.asarray([flags], jnp.uint32))

    return jax.jit(call)


_MESHES = {}


def decode_blocks_sharded(tex_fmt: int, words, mesh, mode_mask=0xFFFFFFFF,
                          flags=0, axis: str = "dp"):
    """Scale-out decode: shard the block batch over `axis` of `mesh`
    and decode every shard with the table's decoder under ONE
    shard_map — block decode is embarrassingly parallel (each 4x4
    block is independent, texture.c:85-96), so the compiled program
    contains ZERO collectives (asserted in tests/test_mppi_sharding
    .py::test_sharded_decode_no_collectives) and throughput scales
    linearly with devices.  `words` is (N, k) int32 with N divisible by
    the axis size; returns sharded (pixels, valid) device arrays."""
    idx = F.compressed_index(tex_fmt)
    if idx not in _DECODERS:
        raise ValueError(f"not a compressed format: {tex_fmt:#x}")
    n_shards = mesh.shape[axis]
    if words.shape[0] % n_shards:
        raise ValueError(
            f"N={words.shape[0]} not divisible by mesh axis "
            f"'{axis}' size {n_shards}")
    # Structural key (device ids + axis layout), NOT id(mesh):
    # equivalent meshes rebuilt per call share one compiled decoder,
    # and the cache stays bounded by distinct topologies.
    mesh_key = (tuple(d.id for d in mesh.devices.ravel()),
                tuple(mesh.shape.items()))
    _MESHES.setdefault(mesh_key, mesh)
    return _sharded_decoder(idx, mesh_key, axis)(
        words, np.uint32(mode_mask), np.uint32(flags))


def _native_bytes(idx: int, pix) -> np.ndarray:
    """Native device arrays -> per-block pixel byte layout (N, 16*ps),
    matching the reference decoders' pixel_buffer layout."""
    kind = _DECODERS[idx][1]
    a = np.asarray(pix)
    n = a.shape[0]
    # Every decoder emits packed words since the round-4 payload
    # rework: the little-endian i32 byte stream IS the reference
    # pixel_buffer layout for every kind.
    assert kind == "u32" or kind.startswith("p"), kind
    return np.ascontiguousarray(a).view(np.uint32).view(np.uint8) \
        .reshape(n, -1)


def decode_blocks(tex_fmt: int, blocks_u8: np.ndarray,
                  mode_mask=0xFFFFFFFF, flags=0, backend: str = "jax"):
    """Decode (N, block_bytes) u8 blocks to native per-block pixel bytes
    ((N, 16*ps) u8) plus validity; invalid blocks are NOT zeroed here —
    callers zero in the *target* format (texture.c:90-93).

    backend: "jax" (the decoder table on the default JAX device) or
    "native" (the multithreaded C++ host runtime)."""
    idx = F.compressed_index(tex_fmt)
    if backend == "native":
        from detex_tpu import native
        out, valid = native.decode(_NATIVE_FAMILY[idx], blocks_u8,
                                   int(mode_mask), int(flags))
        return out, valid
    words = words_from_bytes(blocks_u8)
    pix, valid = decode_blocks_device(tex_fmt, words, mode_mask, flags)
    return _native_bytes(idx, pix), np.asarray(valid)


def _native_to_typed(idx: int, pix):
    """Decoder-native device arrays -> (n_pixels, lanes) typed device
    array in the family's decoded pixel format (same byte layout as
    _native_bytes, kept on device).  Runs under jit."""
    import jax.numpy as jnp
    kind = _DECODERS[idx][1]
    n = pix.shape[0]
    if kind == "u32":
        # Packed 32-bit pixels -> little-endian u8 lanes (R,G,B,A).
        v = pix.astype(jnp.uint32)
        lanes = [(v >> s) & 0xFF for s in (0, 8, 16, 24)]
        return jnp.stack(lanes, axis=-1).astype(jnp.uint8).reshape(-1, 4)
    if kind in ("p8", "p8x2"):
        # Packed u8 payload words -> byte stream -> (n_px, lanes).
        v = pix.astype(jnp.uint32)
        b = jnp.stack([(v >> s) & 0xFF for s in (0, 8, 16, 24)],
                      axis=-1).astype(jnp.uint8)
        lanes = 2 if kind == "p8x2" else 1
        return b.reshape(n * 16, lanes)
    if kind == "p16x4":
        # (N, 32) word pairs: channel planes via strided slices.
        v = pix.astype(jnp.uint32)
        rg, bx = v[:, 0::2], v[:, 1::2]
        h = jnp.stack([rg & 0xFFFF, rg >> 16, bx & 0xFFFF, bx >> 16],
                      axis=-1).astype(jnp.uint16)
        return h.reshape(n * 16, 4)
    if kind in ("p16", "p16x2"):
        # Packed u16 payload words -> u16 stream -> (n_px, lanes).
        v = pix.astype(jnp.uint32)
        h = jnp.stack([v & 0xFFFF, v >> 16], axis=-1).astype(jnp.uint16)
        lanes = {"p16": 1, "p16x2": 2}[kind]
        return h.reshape(n * 16, lanes)
    raise AssertionError(f"unknown packer kind {kind!r}")


# 8-bit x 4-lane formats whose mutual conversions are compositions of
# no-ops and R/B swaps (convert.c:768-778): representable on PACKED
# 32-bit pixels, so the fused pipeline can skip the byte unpack and
# keep the assembly in 32-bit lanes.
_PACKED32_FMTS = frozenset({F.RGBA8, F.RGBX8, F.BGRA8, F.BGRX8})


def _decode_convert_fn(tex_fmt: int, pixel_format: int):
    """words -> (per-block converted pixels with invalid blocks zeroed
    in the target format, lanes).  Packed (N, 16) uint32 for 8-bit
    4-lane targets of packed-pixel decoders (lanes None), else
    (N, 16, lanes) in convert_device's lane representation."""
    import jax.numpy as jnp
    idx = F.compressed_index(tex_fmt)
    dec_fn, kind = _DECODERS[idx]
    src_fmt = F.texture_pixel_format(tex_fmt)
    # Packed fast path: decoder emits packed 32-bit pixels and the
    # conversion is a noop/R-B-swap composition — byte-identical to
    # the lane path, but the whole pipeline stays in u32.
    if (kind == "u32" and src_fmt in _PACKED32_FMTS
            and pixel_format in _PACKED32_FMTS):
        swap = F.is_bgr(src_fmt) != F.is_bgr(pixel_format)

        def packed(words, mode_mask, flags):
            pix, valid = dec_fn(words, mode_mask, flags)
            v = pix.astype(jnp.uint32)
            if swap:
                v = ((v & 0xFF) << 16) | (v & jnp.uint32(0xFF00FF00)) \
                    | ((v >> 16) & 0xFF)
            return jnp.where(valid[:, None], v, jnp.uint32(0))

        return packed, None
    lanes = CD.repr_lanes(pixel_format)

    def converted(words, mode_mask, flags):
        pix, valid = dec_fn(words, mode_mask, flags)
        typed = _native_to_typed(idx, pix)
        conv = CD.convert_pixels_device(typed, src_fmt, pixel_format)
        conv = conv.reshape(valid.shape[0], 16, lanes)
        # Invalid blocks zero in the *target* format (texture.c:125-127).
        return jnp.where(valid[:, None, None], conv,
                         jnp.zeros((), conv.dtype))

    return converted, lanes


@functools.lru_cache(maxsize=None)
def _device_pipeline(tex_fmt: int, pixel_format: int, wb: int, hb: int,
                     width: int, height: int, _params_key: tuple):
    """Jitted decode -> convert -> zero-invalid -> assemble pipeline
    (the whole reference call stack texture.c:105-145 + convert.c as
    ONE device computation, no host round-trip)."""
    import jax.numpy as jnp
    fn, lanes = _decode_convert_fn(tex_fmt, pixel_format)

    def pipeline(words, mode_mask, flags):
        tiles = fn(words, mode_mask, flags).reshape(hb, wb, 4, 4, lanes or 1)
        # (hb, wb, 4, 4, lanes) tiles -> (H, W, lanes) linear image as
        # one strided row slice per pixel row + concat.
        rows = [tiles[:, :, py, :, :].reshape(hb, 1, wb * 4, -1)
                for py in range(4)]
        img = jnp.concatenate(rows, axis=1).reshape(hb * 4, wb * 4, -1)
        return img[:height, :width]

    return jax.jit(pipeline)


@functools.lru_cache(maxsize=None)
def _device_pipeline_tiled(tex_fmt: int, pixel_format: int,
                           _params_key: tuple):
    """Jitted decode -> convert -> zero-invalid pipeline for the TILED
    output layout (reference detexDecompressTextureTiled,
    texture.c:77-98): per-block tiles of 16 converted pixels, no
    relayout."""
    return jax.jit(_decode_convert_fn(tex_fmt, pixel_format)[0])


def _device_words(tex: Texture, pixel_format: int):
    if not F.is_compressed(tex.format):
        raise ValueError("device path requires a compressed texture")
    src_fmt = F.texture_pixel_format(tex.format)
    if not CD.path_supported(src_fmt, pixel_format):
        raise C.ConversionError(
            f"conversion {F.format_name(src_fmt)} -> "
            f"{F.format_name(pixel_format)} is not device-executable")
    return words_from_bytes(tex.data.reshape(tex.n_blocks, tex.block_size))


def decompress_texture_tiled_device(tex: Texture,
                                    pixel_format: int = None,
                                    mode_mask=0xFFFFFFFF, flags=0):
    """Tiled-layout decode fully on device (texture.c:77-98 as one jit):
    returns a device array of per-block converted pixels — packed
    (n_blocks, 16) uint32 for 8-bit 4-lane targets, else
    (n_blocks, 16, lanes) in convert_device's lane representation."""
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    words = _device_words(tex, pixel_format)
    fn = _device_pipeline_tiled(tex.format, pixel_format,
                                CD.hdr_params_key())
    return fn(words, np.uint32(mode_mask), np.uint32(flags))


def decompress_texture_linear_device(tex: Texture,
                                     pixel_format: int = None,
                                     mode_mask=0xFFFFFFFF, flags=0):
    """Whole-texture decode fully on device: returns a (height, width,
    lanes) typed device array in `pixel_format` whose bytes equal the
    host path's.  8-bit 4-lane targets (RGBA8/RGBX8/BGRA8/BGRX8) from
    packed-pixel decoders return (H, W, 1) uint32 PACKED pixels (same
    bytes, 4x fewer lane ops); everything else returns
    convert_device's lane representation.  Every conversion edge
    (incl. HDR gamma != 1, via the device-resident gamma LUT) runs on
    device; ConversionError is raised only when no conversion path
    exists at all for the format pair."""
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    words = _device_words(tex, pixel_format)
    fn = _device_pipeline(tex.format, pixel_format, tex.width_in_blocks,
                          tex.height_in_blocks, tex.width, tex.height,
                          CD.hdr_params_key())
    return fn(words, np.uint32(mode_mask), np.uint32(flags))


def _assemble_linear(block_pixels: np.ndarray, wb: int, hb: int,
                     width: int, height: int, ps: int) -> np.ndarray:
    """(N, 16*ps) per-block pixel bytes -> (height*width*ps,) linear
    bytes, cropping partial edge blocks (texture.c:115-143)."""
    tiles = block_pixels.reshape(hb, wb, 4, 4, ps)
    img = tiles.transpose(0, 2, 1, 3, 4).reshape(hb * 4, wb * 4, ps)
    return np.ascontiguousarray(img[:height, :width]).ravel()


def decompress_texture_linear(tex: Texture, pixel_format: int = None,
                              mode_mask=0xFFFFFFFF, flags=0,
                              backend: str = "jax") -> np.ndarray:
    """Decode a whole texture row-major (reference
    detexDecompressTextureLinear, texture.c:105-145).  Returns flat u8
    bytes of width*height pixels in `pixel_format` (default: the
    format's native decoded pixel format)."""
    global LAST_BACKEND
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    if not F.is_compressed(tex.format):
        src_fmt = F.texture_pixel_format(tex.format)
        n_px = tex.width * tex.height
        if backend == "device" and CD.path_supported(src_fmt,
                                                     pixel_format):
            # Uncompressed textures run the same device converter as
            # the compressed pipeline (texture.c:105-145 parity was
            # host-only until round 5; every edge has a device kernel).
            LAST_BACKEND = "device"
            return CD.convert_pixels_jax(tex.data, n_px, src_fmt,
                                         pixel_format)
        LAST_BACKEND = "jax" if backend == "device" else backend
        return C.convert_pixels(tex.data, n_px, src_fmt, pixel_format)
    if backend == "device":
        # Fully-fused device pipeline (decode+convert+assemble in one
        # jit).  Every conversion edge (incl. HDR gamma != 1) now has
        # a device kernel; a path can still be missing entirely (no
        # edge sequence exists for the format pair), in which case the
        # host converter will raise the same error — but never
        # silently: the downgrade is warned and recorded.
        try:
            img = decompress_texture_linear_device(tex, pixel_format,
                                                   mode_mask, flags)
            LAST_BACKEND = "device"
            return CD.to_bytes(np.asarray(img))
        except C.ConversionError as e:
            import warnings
            warnings.warn(
                f"device pipeline unavailable for this conversion "
                f"({e}); falling back to the host converter",
                RuntimeWarning, stacklevel=2)
            backend = "jax"
    LAST_BACKEND = backend
    blocks = tex.data.reshape(tex.n_blocks, tex.block_size)
    native, valid = decode_blocks(tex.format, blocks, mode_mask, flags,
                                  backend)
    src_fmt = F.texture_pixel_format(tex.format)
    ps_out = F.pixel_size(pixel_format)
    n_px = native.shape[0] * 16
    converted = C.convert_pixels(native.ravel(), n_px, src_fmt,
                                 pixel_format).reshape(native.shape[0],
                                                       16 * ps_out)
    # Invalid blocks are zero in the *target* format (texture.c:125-127).
    converted = np.where(valid[:, None], converted, 0).astype(np.uint8)
    return _assemble_linear(converted, tex.width_in_blocks,
                            tex.height_in_blocks, tex.width, tex.height,
                            ps_out)


def decompress_texture_tiled(tex: Texture, pixel_format: int = None,
                             mode_mask=0xFFFFFFFF, flags=0,
                             backend: str = "jax") -> np.ndarray:
    """Decode into per-block tiles (reference detexDecompressTextureTiled,
    texture.c:77-98): output is blocks of 16 converted pixels, one after
    another."""
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    global LAST_BACKEND
    if not F.is_compressed(tex.format):
        raise ValueError("Cannot handle uncompressed texture format")
    if backend == "device":
        try:
            out = decompress_texture_tiled_device(tex, pixel_format,
                                                  mode_mask, flags)
            LAST_BACKEND = "device"
            arr = np.asarray(out)
            if arr.dtype == np.uint32 and arr.ndim == 2:   # packed
                return np.ascontiguousarray(arr).view(np.uint8).ravel()
            return CD.to_bytes(arr.reshape(arr.shape[0] * 16, -1))
        except C.ConversionError as e:
            import warnings
            warnings.warn(
                f"device pipeline unavailable for this conversion "
                f"({e}); falling back to the host converter",
                RuntimeWarning, stacklevel=2)
            backend = "jax"
    blocks = tex.data.reshape(tex.n_blocks, tex.block_size)
    native, valid = decode_blocks(tex.format, blocks, mode_mask, flags,
                                  backend)
    src_fmt = F.texture_pixel_format(tex.format)
    ps_out = F.pixel_size(pixel_format)
    n_px = native.shape[0] * 16
    converted = C.convert_pixels(native.ravel(), n_px, src_fmt,
                                 pixel_format).reshape(native.shape[0],
                                                       16 * ps_out)
    converted = np.where(valid[:, None], converted, 0).astype(np.uint8)
    LAST_BACKEND = backend
    return converted.ravel()
