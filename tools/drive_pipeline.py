"""End-to-end drive of the FUSED device pipeline: random textures of
every family (odd sizes, so partial edge blocks are cropped) through
`decompress_texture_linear(backend="device")` (decode + convert +
assemble in one jit) on the default JAX device, compared bit for bit
against `backend="native"` (the C++ oracle + host converter).  The
runtime twin of tests/test_convert_device.py.

Usage: python tools/drive_pipeline.py [--size 1021x509] [FAMILY ...]
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from detex_tpu import engine  # noqa: E402
from detex_tpu import formats as F  # noqa: E402
from detex_tpu.texture import Texture  # noqa: E402
from detex_tpu.utils.blocks import (FAMILIES, random_blocks,  # noqa: E402
                                    texture_format)
from detex_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--size", default="1021x509")
    args = ap.parse_args()
    use_compile_cache()
    w, h = (int(v) for v in args.size.split("x"))
    print(f"driving fused device pipeline on {jax.devices()[0].platform}")
    rng = np.random.default_rng(0)
    failures = 0
    for fam in args.families:
        fmt = texture_format(fam)
        n = ((w + 3) // 4) * ((h + 3) // 4)
        tex = Texture.new(fmt, random_blocks(rng, fam, n).reshape(-1), w, h)
        outs = [None] + ([F.BGRA8] if F.texture_pixel_format(fmt)
                         in (F.RGBA8, F.RGBX8) else [])
        for pf in outs:
            want = engine.decompress_texture_linear(tex, pf,
                                                    backend="native")
            got = engine.decompress_texture_linear(tex, pf,
                                                   backend="device")
            ok = (engine.LAST_BACKEND == "device"
                  and np.array_equal(want, got))
            name = F.format_name(pf) if pf else "default"
            print(f"  {fam:20s} -> {name:14s} "
                  f"{'BIT-EXACT' if ok else 'MISMATCH'}")
            failures += not ok
    print(f"{failures} MISMATCHES" if failures else "ALL BIT-EXACT")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
