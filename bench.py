"""Benchmark: BC7 (BPTC) batched block decode throughput on the GPU.

Decodes 2^22 random BC7 blocks (64 MiB in, 256 MiB out — well past the
H100's 50 MB L2) with the engine decoder table's BC7 entry, the same
decoder the control and train steps use.  Each timed sample enqueues
K back-to-back decodes and ends in block_until_ready; the result is
the median over samples, with the spread (max - min) / median.

Before timing, the decode is witnessed bit for bit against the native
C++ oracle (native/dtxnative.cpp); a mismatch or a missing oracle is a
failure, as is a missing GPU.  Prints ONE JSON line:

  {"metric": "bc7_decode_blocks_per_s", "value": N, "unit": "blocks/s",
   "spread_pct": S, "device": {...}, "nvidia_smi": "<name>, <limit>"}

    python bench.py
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import numpy as np  # noqa: E402

N_BLOCKS = 1 << 22
K_CALLS = 20          # decodes enqueued per timed sample
N_SAMPLES = 15


def witness(blocks_u8: np.ndarray) -> None:
    """Bit-compare one full batch from the device decoder against the
    native oracle (reference analogue: validate.c:188-222)."""
    from detex_tpu import engine, native
    from detex_tpu import formats as F
    if not native.available():
        raise RuntimeError("native oracle unavailable (make -C native)")
    got, got_valid = engine.decode_blocks(F.BPTC, blocks_u8, backend="jax")
    want, want_valid = native.decode("BPTC", blocks_u8)
    if not np.array_equal(got_valid, want_valid):
        raise AssertionError(
            f"BC7 valid mask differs on "
            f"{int(np.sum(got_valid != want_valid))} blocks")
    bad = np.nonzero(np.any(got[want_valid] != want[want_valid],
                            axis=1))[0]
    if bad.size:
        raise AssertionError(
            f"BC7 pixels differ on {bad.size} of {int(want_valid.sum())} "
            f"valid blocks (first {bad[0]})")


def bench_decode(blocks_u8: np.ndarray):
    """Median blocks/s and spread (%) of the table's BC7 decoder."""
    from detex_tpu import engine
    from detex_tpu import formats as F
    from detex_tpu.ops.bitops import words_from_bytes
    from detex_tpu.utils.metrics import time_per_call
    words = jax.device_put(words_from_bytes(blocks_u8))
    jax.block_until_ready(engine.decode_blocks_device(F.BPTC, words))
    sec, spread = time_per_call(
        lambda: engine.decode_blocks_device(F.BPTC, words), N_SAMPLES,
        K_CALLS)
    return blocks_u8.shape[0] / sec, spread


def main():
    from detex_tpu.utils.blocks import random_blocks
    from detex_tpu.utils.compile_cache import use_compile_cache
    from detex_tpu.utils.metrics import device_info, nvidia_smi
    device = device_info()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py: no GPU (JAX's first device is "
                 f"{device['platform']!r})")
    use_compile_cache()
    smi = nvidia_smi()
    blocks = random_blocks(np.random.default_rng(42), "BPTC", N_BLOCKS)
    witness(blocks)
    rate, spread = bench_decode(blocks)
    print(json.dumps({
        "metric": "bc7_decode_blocks_per_s",
        "value": rate,
        "unit": "blocks/s",
        "spread_pct": spread,
        "n_blocks": N_BLOCKS,
        "device": device,
        "nvidia_smi": smi,
    }), flush=True)


if __name__ == "__main__":
    main()
