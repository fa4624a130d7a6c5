"""Generate golden vectors for the pixel-conversion engine from the
compiled C reference.

The reference leaves the process rounding mode sticky after normalized
conversions (half-float.c:306 fesetround(FE_DOWNWARD) is never
restored), so results of float-involving conversions depend on call
history.  We pin FE_TONEAREST before every reference call so the
goldens correspond to the default rounding mode, which is what the
numpy implementation reproduces.

Output: tests/golden/convert.npz with entries
    pair{i}_src_fmt / _dst_fmt / _src (bytes) / _out (bytes)

Host-only: needs the C reference's sources (tools/refbind.py), which the
repository does not carry; the committed goldens are its output.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from refbind import Reference  # noqa: E402
from detex_tpu import convert as C  # noqa: E402
from detex_tpu import formats as F  # noqa: E402

N_PIXELS = 2048
FE_TONEAREST = 0

libm = ctypes.CDLL("libm.so.6")


def gen():
    ref = Reference()
    rng = np.random.default_rng(1234)
    pairs = []
    # every direct edge
    for src, dst, _ in C.TABLE:
        pairs.append((src, dst))
    # multi-step paths commonly hit by texture decode
    extra = [
        (F.R8, F.RGBA8), (F.RG8, F.RGBA8), (F.R16, F.RGBA8),
        (F.RG16, F.RGBA8), (F.RGBX8, F.BGRA8), (F.RGBA8, F.BGRX8),
        (F.RGB8, F.RGBA16), (F.RGBA8, F.FLOAT_RGBX16),
        (F.FLOAT_RGBX16, F.RGBX8), (F.FLOAT_RGBX16, F.RGBA8),
        (F.R16, F.FLOAT_R32), (F.FLOAT_R32, F.R8),
        (F.FLOAT_RGB16, F.RGBX8), (F.RGBX16, F.RGBA8),
        (F.FLOAT_RGBX16_HDR, F.RGBX8),
    ]
    pairs += extra
    # ConvertPixel64RGBX16ToPixel48RGB16 (convert.c:704-716) initializes
    # its target pointer from itself (uninitialized) — UB; the compiled
    # reference writes nothing and the output stays zero.  We implement
    # the intended semantics (drop X) instead, so no golden for these.
    broken = {(F.FLOAT_RGBX16, F.FLOAT_RGB16),
              (F.FLOAT_RGBX16_HDR, F.FLOAT_RGB16_HDR)}
    out = {}
    kept = 0
    for src_fmt, dst_fmt in pairs:
        if (src_fmt, dst_fmt) in broken:
            continue
        ps = F.pixel_size(src_fmt)
        data = rng.integers(0, 256, size=(N_PIXELS * ps,), dtype=np.uint8)
        libm.fesetround(FE_TONEAREST)
        try:
            res = ref.convert_pixels(data, N_PIXELS, src_fmt, dst_fmt)
        except RuntimeError as e:
            print(f"skip {F.format_name(src_fmt)}->"
                  f"{F.format_name(dst_fmt)}: {e}")
            continue
        out[f"pair{kept}_src_fmt"] = np.uint32(src_fmt)
        out[f"pair{kept}_dst_fmt"] = np.uint32(dst_fmt)
        out[f"pair{kept}_src"] = data
        out[f"pair{kept}_out"] = res
        kept += 1
    # HDR parameter variants (validate.c:176-186 uses (1, 0, 2)).
    # Each runs in a FRESH process: the reference's sticky fenv state
    # makes gamma!=1 results depend on in-process call history; the
    # golden is the clean single-call behavior.
    import subprocess
    # Each variant pins BOTH HDR conversion families: the f16 -> u16
    # gamma(-LUT) path (hdr.c:119-166) and the f32 -> f32 range map
    # (hdr.c:168-213, which for gamma != 1 maps the RAW value against
    # pow-corrected endpoints — no powf on the pixel itself).
    hdr_variants = [(1.0, 0.0, 2.0), (2.2, 0.0, 4.0), (1.0, -1.0, 3.0),
                    (2.2, 0.0, 1.0), (0.5, -1.0, 3.0)]
    for vi, (gamma, rmin, rmax) in enumerate(hdr_variants):
        data = rng.integers(0, 256, size=(N_PIXELS * 8,), dtype=np.uint8)
        data32 = rng.integers(0, 256, size=(N_PIXELS * 16,),
                              dtype=np.uint8)
        np.save("/tmp/_hdr_src.npy", data)
        np.save("/tmp/_hdr_src32.npy", data32)
        code = (
            "import sys, ctypes, numpy as np\n"
            f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tools')!r}]\n"
            "from refbind import Reference\n"
            "from detex_tpu import formats as F\n"
            "ref = Reference()\n"
            f"ref.lib.detexSetHDRParameters(ctypes.c_float({gamma}),"
            f" ctypes.c_float({rmin}), ctypes.c_float({rmax}))\n"
            "src = np.load('/tmp/_hdr_src.npy')\n"
            f"res = ref.convert_pixels(src, {N_PIXELS},"
            " F.FLOAT_RGBX16_HDR, F.RGBX16)\n"
            "np.save('/tmp/_hdr_out.npy', res)\n"
            "src32 = np.load('/tmp/_hdr_src32.npy')\n"
            f"res32 = ref.convert_pixels(src32, {N_PIXELS},"
            " F.FLOAT_RGBX32_HDR, F.FLOAT_RGBX32)\n"
            "np.save('/tmp/_hdr_out32.npy', res32)\n")
        subprocess.run([sys.executable, "-c", code], check=True)
        res = np.load("/tmp/_hdr_out.npy")
        # float64: the sticky FE_DOWNWARD from earlier reference calls
        # would make np.float32(2.2) round one ulp low in this process.
        out[f"hdr{vi}_params"] = np.float64([gamma, rmin, rmax])
        out[f"hdr{vi}_src"] = data
        out[f"hdr{vi}_out"] = res
        out[f"hdr{vi}_src32"] = data32
        out[f"hdr{vi}_out32"] = np.load("/tmp/_hdr_out32.npy")
    out["n_hdr"] = np.int32(len(hdr_variants))
    out["n_pairs"] = np.int32(kept)
    out["n_pixels"] = np.int32(N_PIXELS)
    np.savez_compressed(REPO / "tests" / "golden" / "convert.npz", **out)
    print(f"wrote {kept} conversion pairs")


if __name__ == "__main__":
    gen()
