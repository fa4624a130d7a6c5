"""Mass randomized bit-exactness sweep: every decode family, device
kernels vs the independent C++ oracle, at production scale (default
1M blocks/family ~ 19M blocks total).

The corpus tests pin 256 blocks/family and the per-round bench
witnesses 64k BC7 blocks; this sweep is the wide-net version — random
bitstrings (valid-mode prefixes where a random prefix would be an
invalid block: BC7 mode byte, BC6H reserved codes) through
engine.decode_blocks on the default device AND through the threaded
native oracle (detex_tpu.native), comparing validity masks everywhere
and pixel bytes on valid blocks (invalid blocks' pixel content is
unspecified; callers zero-fill in the target format, texture.c:90-93).

Usage: python tools/mass_fuzz.py [--blocks 1048576] [--chunk 262144]
           [FAMILY ...]
Prints one line per family and a summary; exits non-zero on any
miscompare.
"""

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from detex_tpu import engine  # noqa: E402
from detex_tpu.utils.blocks import (FAMILIES, random_blocks,  # noqa: E402
                                    texture_format)
from detex_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--blocks", type=int, default=1 << 20)
    ap.add_argument("--chunk", type=int, default=1 << 18)
    args = ap.parse_args()
    use_compile_cache()

    rng = np.random.default_rng(20260821)
    total = 0
    bad = []
    t_all = time.perf_counter()
    for name in args.families:
        fmt = texture_format(name)
        n_done = 0
        t0 = time.perf_counter()
        while n_done < args.blocks:
            n = min(args.chunk, args.blocks - n_done)
            blocks = random_blocks(rng, name, n)
            ours, ov = engine.decode_blocks(fmt, blocks)
            want, wv = engine.decode_blocks(fmt, blocks,
                                            backend="native")
            if not np.array_equal(ov, wv):
                bad.append((name, "valid-mask",
                            int(np.sum(ov != wv))))
                break
            if not np.array_equal(ours[wv], want[wv]):
                diff = np.any(ours[wv] != want[wv], axis=1)
                bad.append((name, "pixels", int(diff.sum())))
                break
            n_done += n
        total += n_done
        print(f"  {name:20s} {n_done:>9,d} blocks "
              f"({int(np.sum(~wv)):,d} invalid in last chunk) "
              f"{'BIT-EXACT' if not bad or bad[-1][0] != name else 'MISCOMPARE'} "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
        if bad and bad[-1][0] == name:
            break
    dt = time.perf_counter() - t_all
    if bad:
        print(f"FAILED: {bad}")
        sys.exit(1)
    print(f"ALL BIT-EXACT: {total:,d} random blocks across "
          f"{len(args.families)} families in {dt:.0f}s "
          f"(device={engine.LAST_BACKEND or 'jax'})")


if __name__ == "__main__":
    main()
