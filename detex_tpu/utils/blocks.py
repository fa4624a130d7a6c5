"""Random compressed blocks for tests, smoke runs and benchmarks.

Uniform random bits, with the mode prefix forced where a family would
otherwise reject most blocks: BC7 gets a uniformly random valid mode
(one-hot prefix), BC6H one of its two 2-bit mode codes (a random
5-bit code is often reserved and fails the block).
"""

from __future__ import annotations

import numpy as np

from detex_tpu import formats as F
from detex_tpu.native import FAMILIES as _NATIVE_IDS

# The 19 family names, in compressed-format index order.
FAMILIES = tuple(_NATIVE_IDS)


def texture_format(family: str) -> int:
    return getattr(F, family)


def random_blocks(rng: np.random.Generator, family: str,
                  n: int) -> np.ndarray:
    """(n, block_bytes) uint8 blocks of `family`."""
    bb = F.block_size_bytes(texture_format(family))
    blocks = rng.integers(0, 256, (n, bb), np.uint8)
    if family == "BPTC":
        modes = rng.integers(0, 8, n)
        blocks[:, 0] = ((1 << modes)
                        | (blocks[:, 0] & (0xFF << (modes + 1)))
                        ).astype(np.uint8)
    elif family in ("BPTC_FLOAT", "BPTC_SIGNED_FLOAT"):
        blocks[:, 0] = ((blocks[:, 0] & 0xFC)
                        | rng.integers(0, 2, n)).astype(np.uint8)
    return blocks
