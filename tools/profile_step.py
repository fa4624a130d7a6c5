"""jax.profiler trace harness for the fused control step
(SURVEY.md §5 tracing row).

Captures a device trace of N control steps into --out (default
<repo>/out/trace); open with TensorBoard's profile plugin or
Perfetto (trace.json.gz inside the run directory).  Also prints the
per-step wall time so the trace can be sanity-checked against
tools/bench_control_step.py numbers.

Usage: python tools/profile_step.py [--steps 20] [--ilqr 2]
"""

import argparse
import functools
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
from detex_tpu.mpc.runtime import ControllerConfig, control_step  # noqa: E402
from detex_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ilqr", type=int, default=0)
    ap.add_argument("--rollouts", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--out", default=str(REPO / "out" / "trace"))
    args = ap.parse_args()
    use_compile_cache()

    cfg = ControllerConfig(
        mppi=M.MPPIConfig(n_rollouts=args.rollouts, horizon=args.horizon,
                          action_dim=8),
        n_ilqr_iterations=args.ilqr)
    dcfg = cfg.dynamics
    params = D.init_params(jax.random.PRNGKey(0), dcfg)
    rng = np.random.default_rng(0)
    n_blocks = (dcfg.image_size // 4) ** 2
    obs = jnp.asarray(rng.integers(-2**31, 2**31, (n_blocks, 4),
                                   np.int64).astype(np.int32))
    nominal = jnp.zeros((cfg.mppi.horizon, cfg.mppi.action_dim),
                        jnp.float32)
    goal = jnp.zeros((dcfg.latent_dim,), jnp.float32)
    step = jax.jit(functools.partial(control_step, cfg=cfg))
    key = jax.random.PRNGKey(0)

    # compile outside the trace window
    a, nominal, _ = step(params, nominal, key, obs, goal)
    jax.block_until_ready(a)

    with jax.profiler.trace(args.out):
        t0 = time.perf_counter()
        for i in range(args.steps):
            key, sub = jax.random.split(key)
            with jax.profiler.StepTraceAnnotation("control_step", step_num=i):
                a, nominal, _ = step(params, nominal, sub, obs ^ i, goal)
        jax.block_until_ready(a)
        dt = (time.perf_counter() - t0) / args.steps
    print(f"traced {args.steps} steps, {dt * 1e3:.3f} ms/step "
          f"(incl. dispatch) -> {args.out}")


if __name__ == "__main__":
    main()
