"""ctypes binding to a compiled build of the C reference (hglm/detex).

Used ONLY by golden-vector generation and property tests: the reference
library is the bit-exactness oracle (SURVEY.md §4 "implications for the
rebuild").  The framework itself never imports this module, and nothing
on the GPU path needs it: it is a host-only tool that needs the C
reference's sources, which the repository does not carry (the native
oracle, native/dtxnative.cpp, serves the runtime checks).

The shared object is built out-of-tree from /root/reference (read-only):
    tools/build_reference.sh /tmp/refbuild
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_DEF_BUILD_DIR = os.environ.get("DETEX_REF_BUILD", "/tmp/refbuild")
_REF_SRC = os.environ.get("DETEX_REF_SRC", "/root/reference")

_REF_LIB_SOURCES = [
    "bits", "clamp", "convert", "dds", "decompress-bc", "decompress-bptc",
    "decompress-bptc-float", "decompress-eac", "decompress-etc",
    "decompress-rgtc", "division-tables", "bptc-tables", "file-info",
    "half-float", "hdr", "ktx", "misc", "raw", "texture",
]


def build_reference(build_dir: str = _DEF_BUILD_DIR) -> str:
    """Compile the reference into build_dir/libdetex_ref.so; returns path."""
    build = Path(build_dir)
    build.mkdir(parents=True, exist_ok=True)
    so = build / "libdetex_ref.so"
    if so.exists():
        return str(so)
    objs = []
    for name in _REF_LIB_SOURCES:
        obj = build / f"{name}.o"
        subprocess.run(
            ["gcc", "-std=gnu99", "-O2", "-fPIC", f"-I{_REF_SRC}",
             "-c", f"{_REF_SRC}/{name}.c", "-o", str(obj)],
            check=True)
        objs.append(str(obj))
    subprocess.run(
        ["gcc", "-shared", "-o", str(so), *objs, "-lm", "-lpthread"],
        check=True)
    return str(so)


class DetexTexture(ctypes.Structure):
    # reference detex.h:729-736
    _fields_ = [
        ("format", ctypes.c_uint32),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("width_in_blocks", ctypes.c_int),
        ("height_in_blocks", ctypes.c_int),
    ]


# (decoder symbol suffix, compressed block bytes, decoded bytes per block)
BLOCK_DECODERS = {
    "BC1": ("BC1", 8, 64),
    "BC1A": ("BC1A", 8, 64),
    "BC2": ("BC2", 16, 64),
    "BC3": ("BC3", 16, 64),
    "RGTC1": ("RGTC1", 8, 16),
    "SIGNED_RGTC1": ("SIGNED_RGTC1", 8, 32),
    "RGTC2": ("RGTC2", 16, 32),
    "SIGNED_RGTC2": ("SIGNED_RGTC2", 16, 64),
    "BPTC": ("BPTC", 16, 64),
    "BPTC_FLOAT": ("BPTC_FLOAT", 16, 128),
    "BPTC_SIGNED_FLOAT": ("BPTC_SIGNED_FLOAT", 16, 128),
    "ETC1": ("ETC1", 8, 64),
    "ETC2": ("ETC2", 8, 64),
    "ETC2_PUNCHTHROUGH": ("ETC2_PUNCHTHROUGH", 8, 64),
    "ETC2_EAC": ("ETC2_EAC", 16, 64),
    "EAC_R11": ("EAC_R11", 8, 32),
    "EAC_SIGNED_R11": ("EAC_SIGNED_R11", 8, 32),
    "EAC_RG11": ("EAC_RG11", 16, 64),
    "EAC_SIGNED_RG11": ("EAC_SIGNED_RG11", 16, 64),
}


class Reference:
    """Thin, numpy-friendly wrapper over the reference shared library."""

    def __init__(self, so_path: str | None = None):
        self.lib = ctypes.CDLL(so_path or build_reference())
        self._decoders = {}
        proto = ctypes.CFUNCTYPE(
            ctypes.c_bool, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8))
        for name, (suffix, _, _) in BLOCK_DECODERS.items():
            fn = getattr(self.lib, f"detexDecompressBlock{suffix}")
            fn.restype = ctypes.c_bool
            fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
                           ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8)]
            self._decoders[name] = fn
        del proto

        self.lib.detexLoadTextureFileWithMipmaps.restype = ctypes.c_bool
        self.lib.detexLoadTextureFileWithMipmaps.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(DetexTexture))),
            ctypes.POINTER(ctypes.c_int),
        ]
        self.lib.detexDecompressTextureLinear.restype = ctypes.c_bool
        self.lib.detexDecompressTextureLinear.argtypes = [
            ctypes.POINTER(DetexTexture), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32]
        self.lib.detexConvertPixels.restype = ctypes.c_bool
        self.lib.detexConvertPixels.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32]
        self.lib.detexGetErrorMessage.restype = ctypes.c_char_p
        self.lib.detexSetHDRParameters.restype = None
        self.lib.detexSetHDRParameters.argtypes = [
            ctypes.c_float, ctypes.c_float, ctypes.c_float]
        self.lib.detexSaveKTXFileWithMipmaps.restype = ctypes.c_bool
        self.lib.detexSaveKTXFileWithMipmaps.argtypes = [
            ctypes.POINTER(ctypes.POINTER(DetexTexture)), ctypes.c_int,
            ctypes.c_char_p]

    # -- per-block decode ---------------------------------------------------
    def decode_blocks(self, family: str, blocks: np.ndarray,
                      mode_mask: int = 0xFFFFFFFF, flags: int = 0):
        """Decode (N, block_bytes) u8 blocks; returns (out u8 (N, out_bytes),
        valid bool (N,)). Invalid blocks are zero-filled like texture.c:90-93."""
        _, in_bytes, out_bytes = BLOCK_DECODERS[family]
        blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
        assert blocks.ndim == 2 and blocks.shape[1] == in_bytes, blocks.shape
        n = blocks.shape[0]
        out = np.zeros((n, out_bytes), dtype=np.uint8)
        valid = np.zeros((n,), dtype=bool)
        fn = self._decoders[family]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        scratch = np.zeros((out_bytes,), dtype=np.uint8)
        for i in range(n):
            scratch[:] = 0
            ok = fn(blocks[i].ctypes.data_as(u8p), mode_mask, flags,
                    scratch.ctypes.data_as(u8p))
            valid[i] = ok
            if ok:
                out[i] = scratch
        return out, valid

    # -- file load ----------------------------------------------------------
    def load_texture(self, path: str):
        """Load mip 0 of a KTX/DDS file; returns (format, data u8, w, h)."""
        texpp = ctypes.POINTER(ctypes.POINTER(DetexTexture))()
        nmips = ctypes.c_int(0)
        ok = self.lib.detexLoadTextureFileWithMipmaps(
            path.encode(), 32, ctypes.byref(texpp), ctypes.byref(nmips))
        if not ok:
            raise RuntimeError(
                f"reference load failed for {path}: "
                f"{self.lib.detexGetErrorMessage().decode()}")
        tex = texpp[0][0]
        from detex_tpu import formats as F
        if F.is_compressed(tex.format):
            size = tex.width_in_blocks * tex.height_in_blocks * \
                F.block_size_bytes(tex.format)
        else:
            size = tex.width * tex.height * F.pixel_size(tex.format)
        data = np.ctypeslib.as_array(tex.data, shape=(size,)).copy()
        return int(tex.format), data, int(tex.width), int(tex.height)

    def decompress_texture_linear(self, tex_format: int, data: np.ndarray,
                                  width: int, height: int, out_format: int):
        from detex_tpu import formats as F
        tex = DetexTexture()
        tex.format = tex_format
        data = np.ascontiguousarray(data, dtype=np.uint8)
        tex.data = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        tex.width, tex.height = width, height
        tex.width_in_blocks = (width + 3) // 4
        tex.height_in_blocks = (height + 3) // 4
        out = np.zeros((width * height * F.pixel_size(out_format),),
                       dtype=np.uint8)
        ok = self.lib.detexDecompressTextureLinear(
            ctypes.byref(tex), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)), out_format)
        if not ok:
            raise RuntimeError(
                f"reference decompress failed: "
                f"{self.lib.detexGetErrorMessage().decode()}")
        return out

    def save_ktx(self, tex_format: int, data: np.ndarray, width: int,
                 height: int, path: str) -> None:
        """detexSaveKTXFileWithMipmaps for a single-level texture."""
        from detex_tpu import formats as F
        tex = DetexTexture()
        tex.format = tex_format
        data = np.ascontiguousarray(data, dtype=np.uint8)
        tex.data = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        tex.width, tex.height = width, height
        if F.is_compressed(tex_format):
            tex.width_in_blocks = (width + 3) // 4
            tex.height_in_blocks = (height + 3) // 4
        else:
            tex.width_in_blocks = tex.height_in_blocks = 0
        texp = ctypes.pointer(tex)
        arr = (ctypes.POINTER(DetexTexture) * 1)(texp)
        ok = self.lib.detexSaveKTXFileWithMipmaps(arr, 1, path.encode())
        if not ok:
            raise RuntimeError(
                f"reference save failed: "
                f"{self.lib.detexGetErrorMessage().decode()}")

    def convert_pixels(self, src: np.ndarray, n_pixels: int, src_fmt: int,
                       dst_fmt: int) -> np.ndarray:
        from detex_tpu import formats as F
        src = np.ascontiguousarray(src, dtype=np.uint8).copy()
        out = np.zeros((n_pixels * F.pixel_size(dst_fmt),), dtype=np.uint8)
        ok = self.lib.detexConvertPixels(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_pixels,
            src_fmt, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dst_fmt)
        if not ok:
            raise RuntimeError(
                f"convert {src_fmt:#x}->{dst_fmt:#x} failed: "
                f"{self.lib.detexGetErrorMessage().decode()}")
        return out

    def read_table(self, symbol: str, count: int, dtype) -> np.ndarray:
        addr = ctypes.addressof(
            ctypes.c_uint8.in_dll(self.lib, symbol))
        nbytes = count * np.dtype(dtype).itemsize
        buf = (ctypes.c_uint8 * nbytes).from_address(addr)
        return np.frombuffer(bytes(buf), dtype=dtype).copy()
