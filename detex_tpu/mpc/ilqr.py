"""iLQR trajectory optimizer — scan-based Riccati, jit/pjit friendly.

New component (no reference counterpart).  Refines an MPPI
plan with a few Gauss-Newton iterations:

  linearize   : per-step jacobians via vmap(jacfwd) along the trajectory
  backward    : Riccati recursion — either a reverse lax.scan (depth H)
                or the log-depth parallel LQT (parallel=True: the
                Gauss-Newton subproblem IS an LQT, solved with the
                associative-scan elements of parallel_lqr.py; its
                element combines are batched matmuls)
  forward     : rollout with a line search vmapped over all alphas

Everything is functional and static-shaped: horizon and iteration
counts are compile-time constants, so the whole solve jits into one
XLA program.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from detex_tpu.mpc import parallel_lqr as PL


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    n_iterations: int = 5
    reg_init: float = 1e-6
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)
    # Solve each Gauss-Newton subproblem with the log-depth parallel
    # LQT instead of the sequential reverse scan.  Wins once H is large
    # (the combine is O(n^3) per element but depth log2(H) vs H).
    parallel: bool = False


def _rollout(dynamics, x0, us):
    def step(x, u):
        x_next = dynamics(x, u)
        return x_next, x
    _, xs = jax.lax.scan(step, x0, us)
    return jnp.concatenate([xs, jnp.zeros_like(xs[:1])], axis=0) \
        .at[-1].set(dynamics(xs[-1], us[-1]))


def trajectory_cost(cost, terminal_cost, xs, us):
    ts = jnp.arange(us.shape[0])
    stage = jax.vmap(cost)(xs[:-1], us, ts)
    return jnp.sum(stage) + terminal_cost(xs[-1])


def ilqr_solve(dynamics: Callable, cost: Callable,
               terminal_cost: Callable, x0: jnp.ndarray,
               us_init: jnp.ndarray, cfg: ILQRConfig = ILQRConfig()):
    """Iterative LQR.

    dynamics: (x, u) -> x'        (single trajectory, unbatched)
    cost: (x, u, t) -> scalar;    terminal_cost: (x,) -> scalar
    Returns (xs (H+1, n), us (H, m), total_cost)."""
    h, m = us_init.shape
    n = x0.shape[0]

    f_jac = jax.vmap(jax.jacfwd(dynamics, argnums=(0, 1)))
    c_grad = jax.vmap(jax.grad(cost, argnums=(0, 1)), in_axes=(0, 0, 0))

    def c_hess(xs, us, ts):
        hxx = jax.vmap(jax.hessian(cost, argnums=0))(xs, us, ts)
        huu = jax.vmap(jax.hessian(cost, argnums=1))(xs, us, ts)
        hux = jax.vmap(jax.jacfwd(jax.grad(cost, argnums=1),
                                  argnums=0))(xs, us, ts)
        return hxx, huu, hux

    def backward(fx, fu, lx, lu, lxx, luu, lux, vx_T, vxx_T, reg):
        def step(carry, inp):
            vx, vxx = carry
            fx_t, fu_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
            qx = lx_t + fx_t.T @ vx
            qu = lu_t + fu_t.T @ vx
            qxx = lxx_t + fx_t.T @ vxx @ fx_t
            quu = luu_t + fu_t.T @ vxx @ fu_t
            qux = lux_t + fu_t.T @ vxx @ fx_t
            quu_reg = quu + reg * jnp.eye(m)
            chol = jax.scipy.linalg.cho_factor(quu_reg)
            k_t = -jax.scipy.linalg.cho_solve(chol, qu)
            bigk_t = -jax.scipy.linalg.cho_solve(chol, qux)
            vx_new = qx + bigk_t.T @ quu @ k_t + bigk_t.T @ qu \
                + qux.T @ k_t
            vxx_new = qxx + bigk_t.T @ quu @ bigk_t + bigk_t.T @ qux \
                + qux.T @ bigk_t
            vxx_new = 0.5 * (vxx_new + vxx_new.T)
            return (vx_new, vxx_new), (k_t, bigk_t)

        (_, _), (ks, bigks) = jax.lax.scan(
            step, (vx_T, vxx_T),
            (fx, fu, lx, lu, lxx, luu, lux), reverse=True)
        return ks, bigks

    def backward_parallel(fx, fu, lx, lu, lxx, luu, lux, vx_T, vxx_T,
                          reg):
        """Log-depth backward: the subproblem is an LQT with Q=lxx,
        q=lx, R=luu+reg I, r=lu, M=lux, c=0 in deviation variables."""
        r_reg = luu + reg * jnp.eye(m)[None]
        zeros_c = jnp.zeros((h, n), fx.dtype)
        p_all, eta_all = PL.lqt_backward_parallel(
            fx, fu, zeros_c, lxx, lx, r_reg, lu, lux, vxx_T, vx_T)
        bigk, kff = PL.lqt_gains(fx, fu, zeros_c, r_reg, lu, lux,
                                 p_all[1:], eta_all[1:])
        return -kff, -bigk

    def forward(xs_ref, us_ref, ks, bigks, alpha):
        def step(x, inp):
            x_ref, u_ref, k_t, bigk_t = inp
            u = u_ref + alpha * k_t + bigk_t @ (x - x_ref)
            x_next = dynamics(x, u)
            return x_next, (x, u)
        _, (xs_new, us_new) = jax.lax.scan(
            step, x0, (xs_ref[:-1], us_ref, ks, bigks))
        x_last = dynamics(xs_new[-1], us_new[-1])
        xs_full = jnp.concatenate([xs_new, x_last[None]], axis=0)
        return xs_full, us_new

    def iteration(carry, _):
        xs, us, total, reg = carry
        ts = jnp.arange(h)
        fx, fu = f_jac(xs[:-1], us)
        lx, lu = c_grad(xs[:-1], us, ts)
        lxx, luu, lux = c_hess(xs[:-1], us, ts)
        vx_T = jax.grad(terminal_cost)(xs[-1])
        vxx_T = jax.hessian(terminal_cost)(xs[-1])
        bwd = backward_parallel if cfg.parallel else backward
        # Full f32 Riccati products: on a GPU an f32 matmul at default
        # precision may run as TF32 (~3 decimal digits), too coarse for
        # the backward recursion.
        with jax.default_matmul_precision("highest"):
            ks, bigks = bwd(fx, fu, lx, lu, lxx, luu, lux, vx_T, vxx_T,
                            reg)

        def try_alpha(alpha):
            xs_a, us_a = forward(xs, us, ks, bigks, alpha)
            return trajectory_cost(cost, terminal_cost, xs_a, us_a), \
                xs_a, us_a

        # All line-search candidates roll out together (one batched
        # scan instead of len(alphas) sequential rollouts).
        costs, xs_all, us_all = jax.vmap(try_alpha)(
            jnp.asarray(cfg.alphas, jnp.float32))
        best = jnp.argmin(costs)
        xs_best = xs_all[best]
        us_best = us_all[best]
        best_cost = costs[best]
        improved = best_cost < total
        xs = jnp.where(improved, xs_best, xs)
        us = jnp.where(improved, us_best, us)
        total_new = jnp.where(improved, best_cost, total)
        reg_new = jnp.where(improved, jnp.maximum(reg * 0.5, 1e-9),
                            reg * 10.0)
        return (xs, us, total_new, reg_new), total_new

    xs0 = _rollout(dynamics, x0, us_init)
    total0 = trajectory_cost(cost, terminal_cost, xs0, us_init)
    (xs, us, total, _), _ = jax.lax.scan(
        iteration, (xs0, us_init, total0, jnp.float32(cfg.reg_init)),
        None, length=cfg.n_iterations)
    return xs, us, total
