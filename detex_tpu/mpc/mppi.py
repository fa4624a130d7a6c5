"""MPPI (Model Predictive Path Integral) sampling MPC — batched, sharded.

New component (no reference counterpart).  K rollouts of
horizon H are evaluated in parallel:

    u*_t = sum_k w_k c_k,t / sum_k w_k,   w_k = exp(-(S_k - min S)/T)

Multi-chip story (both paths produce the same update, to fp reduction
order):

  * ``mppi_step(..., rollout_axis="dp", mesh=mesh)`` — explicit
    ``jax.shard_map`` over the rollout axis: every device rolls out its
    K/n_dp shard, the softmax-weight normalization is a ``psum`` over
    'dp' and the baseline subtraction a ``pmin``, so the multi-chip
    program is the single-device program + three collectives.
  * ``mppi_step(..., rollout_axis="dp")`` (no mesh) — GSPMD path:
    ``with_sharding_constraint`` pins the noise/controls/costs to
    P('dp') and XLA lowers the reductions to all-reduces itself.
    Composes freely with tensor-parallel dynamics params.

The noise is always drawn *globally* from the caller's key, so results
are invariant to the device count (only reduction order differs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    n_rollouts: int = 8192
    horizon: int = 32
    action_dim: int = 8
    temperature: float = 1.0
    noise_sigma: float = 0.3
    action_low: float = -1.0
    action_high: float = 1.0


def rollout_costs(dynamics: Callable, cost: Callable, z0: jnp.ndarray,
                  controls: jnp.ndarray, terminal_cost: Callable = None,
                  vary_axis: Optional[str] = None):
    """Evaluate per-rollout trajectory costs.

    dynamics: (z, u) -> z'     batched over leading axis
    cost:     (z, u, t) -> (K,) stage costs
    z0: (latent,) or (K, latent); controls: (K, H, action_dim)
    vary_axis: when called inside shard_map over a mesh axis, the name
    of that axis — the scan carry must be cast device-varying up front.
    Returns (K,) total costs."""
    k = controls.shape[0]
    if z0.ndim == 1:
        z0 = jnp.broadcast_to(z0[None, :], (k, z0.shape[0]))
    acc0 = jnp.zeros((k,), jnp.float32)
    if vary_axis is not None:
        axes = (vary_axis,) if isinstance(vary_axis, str) \
            else tuple(vary_axis)
        z0 = jax.lax.pcast(z0, axes, to="varying")
        acc0 = jax.lax.pcast(acc0, axes, to="varying")

    def step(carry, inp):
        z, acc = carry
        u, t = inp
        c = cost(z, u, t)
        z_next = dynamics(z, u)
        return (z_next, acc + c), None

    ts = jnp.arange(controls.shape[1])
    (z_final, total), _ = jax.lax.scan(
        step, (z0, acc0),
        (jnp.swapaxes(controls, 0, 1), ts))
    if terminal_cost is not None:
        total = total + terminal_cost(z_final)
    return total


def _mppi_update(eps, nominal, z0, dynamics, cost, cfg: MPPIConfig,
                 terminal_cost, n_total: int, axis=None):
    """Core MPPI update from a (local) noise shard.

    When `axis` is set the function runs *inside* shard_map: eps holds
    this device's rollouts and every reduction pairs with a collective
    over `axis`.  A tuple axis (e.g. ('dcn', 'ici')) reduces
    hierarchically, innermost (within-host) axis first, so only the
    final O(H*A) partial crosses the outer (between-hosts) axis
    (parallel/distributed.py mesh layout)."""
    axes = (axis,) if isinstance(axis, str) else axis
    controls = jnp.clip(nominal[None] + eps, cfg.action_low,
                        cfg.action_high)
    costs = rollout_costs(dynamics, cost, z0, controls, terminal_cost,
                          vary_axis=axis)
    beta = jnp.min(costs)
    if axes is not None:
        for ax in reversed(axes):  # within a host first, then between
            beta = jax.lax.pmin(beta, ax)
    w = jnp.exp(-(costs - beta) / cfg.temperature)
    # Weighted average of the *clipped* perturbed controls.
    weighted = jnp.einsum("k,kha->ha", w, controls)
    w_sum = jnp.sum(w)
    w2_sum = jnp.sum(w * w)
    cost_sum = jnp.sum(costs)
    if axes is not None:
        for ax in reversed(axes):
            weighted, w_sum, w2_sum, cost_sum = jax.lax.psum(
                (weighted, w_sum, w2_sum, cost_sum), ax)
    new_nominal = weighted / w_sum
    diagnostics = {
        "min_cost": beta,
        "mean_cost": cost_sum / n_total,
        "ess": (w_sum * w_sum) / w2_sum,
    }
    return new_nominal, diagnostics


def mppi_step(key, nominal: jnp.ndarray, z0: jnp.ndarray,
              dynamics: Callable, cost: Callable, cfg: MPPIConfig,
              terminal_cost: Callable = None,
              rollout_axis: Optional[str] = None,
              mesh: Optional[Mesh] = None):
    """One MPPI update of the nominal control sequence.

    nominal: (H, A); returns (new_nominal (H, A), diagnostics dict).

    rollout_axis=None        : single-device program (or let GSPMD
                               decide — reductions still lower to psums
                               if inputs arrive sharded).
    rollout_axis, mesh=None  : GSPMD — with_sharding_constraint pins the
                               rollout batch to P(rollout_axis); needs
                               an ambient mesh (jax.sharding.set_mesh or
                               `with mesh:` around the jit call site).
    rollout_axis + mesh      : explicit shard_map + psum/pmin.
    """
    h, a = nominal.shape
    eps = jax.random.normal(key, (cfg.n_rollouts, h, a), jnp.float32) \
        * cfg.noise_sigma

    if rollout_axis is None:
        return _mppi_update(eps, nominal, z0, dynamics, cost, cfg,
                            terminal_cost, cfg.n_rollouts)

    if mesh is None:
        eps = jax.lax.with_sharding_constraint(eps, P(rollout_axis))
        controls_update = _mppi_update(eps, nominal, z0, dynamics, cost,
                                       cfg, terminal_cost, cfg.n_rollouts)
        return controls_update

    axis_tuple = (rollout_axis,) if isinstance(rollout_axis, str) \
        else tuple(rollout_axis)
    n_shards = int(np.prod([mesh.shape[a] for a in axis_tuple]))
    if cfg.n_rollouts % n_shards:
        raise ValueError(
            f"n_rollouts={cfg.n_rollouts} not divisible by mesh axes "
            f"{axis_tuple} total size {n_shards}")

    def body(eps_local):
        return _mppi_update(eps_local, nominal, z0, dynamics, cost, cfg,
                            terminal_cost, cfg.n_rollouts,
                            axis=rollout_axis)

    diag_specs = {"min_cost": P(), "mean_cost": P(), "ess": P()}
    in_spec = P(rollout_axis if isinstance(rollout_axis, str)
                else axis_tuple)
    return jax.shard_map(body, mesh=mesh, in_specs=in_spec,
                         out_specs=(P(), diag_specs))(eps)


def receding_horizon_shift(nominal: jnp.ndarray) -> jnp.ndarray:
    """Shift the plan one step: drop u_0, repeat the last action."""
    return jnp.concatenate([nominal[1:], nominal[-1:]], axis=0)
