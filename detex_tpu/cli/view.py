"""dtx-view: texture viewer (headless: renders to PNG).

The reference viewer (detex-view.c) decompresses any supported file to
BGRA8/BGRX8 and paints it in a GTK window with nearest-filter zoom
(detex-view.c:126-183).  This environment is headless, so the viewer
decodes through the same path and writes a (optionally nearest-zoomed)
PNG plus format info to stdout.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from detex_tpu import engine
from detex_tpu import formats as F
from detex_tpu import io as tio
from detex_tpu.io import registry
from detex_tpu.texture import Texture
from detex_tpu.utils.compile_cache import use_compile_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dtx-view",
                                description="View a texture file")
    p.add_argument("input_file")
    p.add_argument("-o", "--output", default=None,
                   help="output PNG (default: <input>.view.png)")
    p.add_argument("-z", "--zoom", type=int, default=1,
                   help="integer nearest-neighbour zoom factor")
    args = p.parse_args(argv)
    use_compile_cache()

    textures = tio.load_texture_file(args.input_file, max_mipmaps=1)
    tex = textures[0]
    info = registry.by_format(tex.format)
    name = info.text1 if info else f"0x{tex.format:08X}"
    print(f"{args.input_file}: {tex.width}x{tex.height} {name}")

    # Decode to RGBA8 where possible (the reference uses BGRA8 because
    # cairo wants it; PNG wants RGBA).
    if F.is_compressed(tex.format) or tex.format != F.RGBA8:
        try:
            backend = "device" if F.is_compressed(tex.format) else "jax"
            pixels = engine.decompress_texture_linear(tex, F.RGBA8,
                                                      backend=backend)
        except Exception:
            # HDR/float formats: map via the HDR pipeline to RGBX16
            from detex_tpu import convert as C
            native_fmt = F.texture_pixel_format(tex.format)
            native = engine.decompress_texture_linear(tex)
            u16 = C.convert_pixels(native, tex.width * tex.height,
                                   native_fmt | F.HDR, F.RGBX16)
            pixels = C.convert_pixels(u16, tex.width * tex.height,
                                      F.RGBX16, F.RGBA8)
    else:
        pixels = tex.data
    img = pixels.reshape(tex.height, tex.width, 4)
    if args.zoom > 1:
        img = np.repeat(np.repeat(img, args.zoom, 0), args.zoom, 1)
    out_name = args.output or f"{args.input_file}.view.png"
    out_tex = Texture.new(F.RGBA8, img.ravel(), img.shape[1], img.shape[0])
    tio.save_png(out_tex, out_name)
    print(f"wrote {out_name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
