"""North-star control step timing on the GPU (BASELINE.md config 5).

Times the fused control step — BC7 obs decode -> conv latent encode ->
MPPI (8192 rollouts x H=32) -> optional iLQR refinement — through
Controller.step, which blocks for each action, and through
PipelinedController, which returns the previous step's action while
the device plans on the current one.  Reports the median ms per step
and its spread over `--steps` steps after warm-up, beside the device
and the card's name and power limit.

Usage: python tools/bench_control_step.py [--ilqr 0 2] [--steps 100]
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from detex_tpu.mpc import dynamics as D  # noqa: E402
from detex_tpu.mpc import mppi as M  # noqa: E402
from detex_tpu.mpc.runtime import (Controller, ControllerConfig,  # noqa: E402
                                   PipelinedController)
from detex_tpu.utils.blocks import random_blocks  # noqa: E402
from detex_tpu.utils.compile_cache import use_compile_cache  # noqa: E402
from detex_tpu.utils.metrics import device_info, nvidia_smi  # noqa: E402


def bench(cfg: ControllerConfig, pipelined: bool, n_steps: int):
    """(median ms per step, spread %) of host-in-the-loop steps, each
    on a fresh observation."""
    dcfg = cfg.dynamics
    params = D.init_params(jax.random.PRNGKey(0), dcfg)
    goal = jnp.zeros((dcfg.latent_dim,), jnp.float32)
    rng = np.random.default_rng(0)
    n_blocks = (dcfg.image_size // 4) ** 2
    obs = [random_blocks(rng, "BPTC", n_blocks).view(np.uint32)
           .view(np.int32) for _ in range(8)]
    ctl = (PipelinedController if pipelined else Controller)(
        params, goal, cfg, seed=0)
    for i in range(4):                      # compile + warm
        ctl.step(obs[i % 8])
    ts = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        ctl.step(obs[i % 8])
        ts.append(time.perf_counter() - t0)
    if pipelined:
        ctl.flush()
    med = float(np.median(ts))
    return med * 1e3, 100.0 * (max(ts) - min(ts)) / med


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ilqr", type=int, nargs="*", default=[0, 2])
    ap.add_argument("--rollouts", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    use_compile_cache()
    device = device_info()
    smi = nvidia_smi() if device["platform"] == "gpu" else "no GPU"
    for n_ilqr in args.ilqr:
        cfg = ControllerConfig(
            mppi=M.MPPIConfig(n_rollouts=args.rollouts,
                              horizon=args.horizon, action_dim=8),
            n_ilqr_iterations=n_ilqr)
        for pipelined in (False, True):
            ms, spread = bench(cfg, pipelined, args.steps)
            print(json.dumps({
                "metric": "control_step_ms",
                "ilqr_iterations": n_ilqr,
                "pipelined": pipelined,
                "ms_per_step": ms,
                "spread_pct": spread,
                "within_10ms_budget": ms <= 10.0,
                "device": device,
                "nvidia_smi": smi,
            }), flush=True)


if __name__ == "__main__":
    main()
