"""End-to-end drive: decode blocks of every family through the public
engine API on the default JAX device and compare bit for bit against
the native C++ oracle (detex_tpu.native, built from native/).  A runtime
smoke test (not a pytest) of the user flow: block data -> batched
decode on the device.

Blocks are random (valid mode prefixes forced, detex_tpu.utils.blocks)
unless --corpus names a directory of the reference's test-texture-*.ktx
files, whose blocks are then decoded too.

Usage: python tools/drive_decode.py [--blocks 65536] [--corpus DIR]
           [FAMILY ...]
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from detex_tpu import engine, native  # noqa: E402
from detex_tpu import io as tio  # noqa: E402
from detex_tpu.utils.blocks import (FAMILIES, random_blocks,  # noqa: E402
                                    texture_format)
from detex_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


def same(fam, blocks) -> bool:
    fmt = texture_format(fam)
    ours, valid = engine.decode_blocks(fmt, blocks, backend="jax")
    want, want_valid = native.decode(fam, blocks)
    return (np.array_equal(valid, want_valid)
            and np.array_equal(ours[want_valid], want[want_valid]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--blocks", type=int, default=1 << 16)
    ap.add_argument("--corpus", type=Path, default=None)
    args = ap.parse_args()
    use_compile_cache()
    if not native.available():
        sys.exit("native oracle unavailable (make -C native)")
    print(f"driving {len(args.families)} families on "
          f"{jax.devices()[0].platform}")
    rng = np.random.default_rng(0)
    n_fail = 0
    for fam in args.families:
        sets = [("random", random_blocks(rng, fam, args.blocks))]
        path = args.corpus and args.corpus / f"test-texture-{fam}.ktx"
        if path and path.exists():
            tex = tio.load_ktx(str(path))[0]
            sets.append(("corpus", tex.data.reshape(tex.n_blocks,
                                                    tex.block_size)))
        for name, blocks in sets:
            ok = same(fam, blocks)
            print(f"  {fam:20s} {name:6s} {blocks.shape[0]:7d} blocks: "
                  f"{'BIT-EXACT' if ok else 'MISMATCH'} "
                  f"({engine.decoder_name(texture_format(fam))})")
            n_fail += not ok
    print("FAIL" if n_fail else "ALL BIT-EXACT")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
