"""Structured per-step metrics (SURVEY.md §5 observability: the
reference has none beyond printf; the rebuild emits JSON lines)."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional, TextIO


class MetricsLogger:
    """Emit one JSON line per step: {"step": n, "t": epoch_s, ...}."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream or sys.stdout
        self._t0 = time.time()

    def log(self, step: int, **values: Any) -> None:
        rec: Dict[str, Any] = {"step": step,
                               "t": round(time.time() - self._t0, 6)}
        for k, v in values.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()


class Timer:
    """Wall-clock timing context for step-budget accounting (the 10 ms
    control-step budget in BASELINE.md)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self.t0
        return False


def nvidia_smi() -> str:
    """Card name and power limit as `nvidia-smi` reports them (a child
    process, so the caller's JAX state is untouched)."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def device_info() -> Dict[str, Any]:
    """The device every result must name: platform, kind and count."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def time_samples(fn, samples: int, k: int = 1):
    """Seconds per call of fn(), one value per sample.  Each sample
    enqueues `k` calls and ends in block_until_ready; k = 1 times a
    host-synchronous step."""
    import jax
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(k):
            out = fn()
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / k)
    return ts


def time_per_call(fn, samples: int, k: int = 1):
    """Median seconds per call of fn() and the spread in per cent,
    (max - min) / median (see time_samples)."""
    import numpy as np
    ts = time_samples(fn, samples, k)
    med = float(np.median(ts))
    return med, 100.0 * (max(ts) - min(ts)) / med
