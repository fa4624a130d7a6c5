"""Parallel (log-depth) LQR via associative scan.

The long-horizon scaling analogue of sequence parallelism (SURVEY.md §5
"long-context"): the Riccati backward pass is a sequential recursion of
depth H; reformulated as an associative combination of conditional
value-function elements it runs in O(log H) depth with
jax.lax.associative_scan, and the elementwise combines are batched
matmuls.  (Cf. Särkkä & García-Fernández, temporal parallelization of LQR.)

Element (A, b, C, eta, J) represents the optimal cost-to-go between two
times conditioned on both endpoint states; combination eliminates the
intermediate state:

  A12 = A2 M A1            M  = (I + C1 J2)^{-1}
  b12 = A2 M (b1 + C1 eta2) + b2
  C12 = A2 M C1 A2' + C2
  e12 = A1' N (eta2 - J2 b1) + eta1     N = (I + J2 C1)^{-1}
  J12 = A1' N J2 A1 + J1

For time-invariant or time-varying linear dynamics x' = F x + L u + c
with stage cost 0.5 x'X x + 0.5 u'U u, the suffix-combined element at
time k gives the value Hessian P_k = J_k* and value gradient -eta_k*.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _combine(e1, e2):
    """Associative combination; e1 covers the earlier interval."""
    a1, b1, c1, eta1, j1 = e1
    a2, b2, c2, eta2, j2 = e2
    n = a1.shape[-1]
    eye = jnp.eye(n, dtype=a1.dtype)
    m = jnp.linalg.solve(eye + c1 @ j2, eye)
    nmat = jnp.linalg.solve(eye + j2 @ c1, eye)
    a12 = a2 @ m @ a1
    b12 = (a2 @ m @ (b1[..., None] + c1 @ eta2[..., None]))[..., 0] + b2
    c12 = a2 @ m @ c1 @ jnp.swapaxes(a2, -1, -2) + c2
    eta12 = (jnp.swapaxes(a1, -1, -2)
             @ nmat @ (eta2[..., None] - j2 @ b1[..., None]))[..., 0] + eta1
    j12 = jnp.swapaxes(a1, -1, -2) @ nmat @ j2 @ a1 + j1
    return a12, b12, c12, eta12, j12


_combine_v = jax.vmap(_combine)


def lqr_backward_parallel(f_mat, l_mat, c_vec, x_cost, u_cost, x_terminal):
    """Backward value functions for a (time-varying) LQR in parallel.

    f_mat (H, n, n), l_mat (H, n, m), c_vec (H, n), x_cost (H, n, n),
    u_cost (H, m, m), x_terminal (n, n).
    Returns (P (H+1, n, n), eta (H+1, n)) with P_k the value Hessian at
    time k (P_H = x_terminal) and value gradient -eta_k."""
    h, n, _ = f_mat.shape
    u_inv = jnp.linalg.inv(u_cost)
    c_elem = l_mat @ u_inv @ jnp.swapaxes(l_mat, -1, -2)
    elems = (
        jnp.concatenate([f_mat, jnp.zeros((1, n, n), f_mat.dtype)]),
        jnp.concatenate([c_vec, jnp.zeros((1, n), f_mat.dtype)]),
        jnp.concatenate([c_elem, jnp.zeros((1, n, n), f_mat.dtype)]),
        jnp.zeros((h + 1, n), f_mat.dtype),
        jnp.concatenate([x_cost, x_terminal[None]]),
    )
    # reverse=True feeds the combiner (suffix, element) = (later,
    # earlier); our _combine expects (earlier, later).
    combined = jax.lax.associative_scan(
        lambda a, b: _combine_v(b, a), elems, reverse=True)
    _, _, _, eta, j = combined
    return j, eta


def lqr_gains_from_value(f_mat, l_mat, c_vec, u_cost, p_next, eta_next):
    """Feedback/feedforward gains from the next-step value function:
    u_k = -K_k x_k - k_k."""
    lt = jnp.swapaxes(l_mat, -1, -2)
    quu = u_cost + lt @ p_next @ l_mat
    k_fb = jnp.linalg.solve(quu, lt @ p_next @ f_mat)
    rhs = lt @ (p_next @ c_vec[..., None] - eta_next[..., None])
    k_ff = jnp.linalg.solve(quu, rhs)[..., 0]
    return k_fb, k_ff


def lqt_backward_parallel(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat,
                          r_vec, m_mat, p_term, p_vec_term):
    """General parallel LQT backward pass (linear + cross cost terms).

    Stage k: dynamics x⁺ = F x + L u + c, cost
        0.5 x'Q x + q'x + 0.5 u'R u + r'u + u'M x
    terminal 0.5 x'P_T x + p_T'x.  All per-stage args (H, ...).

    This is what iLQR's Gauss-Newton subproblem is: Q=lxx, q=lx,
    R=luu(+reg), r=lu, M=lux around the current trajectory.  The cross
    and control-linear terms are folded into the state cost by the
    substitution u = v - R^{-1}(M x + r):

        Q~ = Q - M'R^{-1}M   q~ = q - M'R^{-1}r
        F~ = F - L R^{-1}M   c~ = c - L R^{-1}r

    after which the element scan of lqr_backward_parallel applies with
    eta seeded from the linear terms (value gradient at x is
    P_k x - eta_k).

    Returns (P (H+1, n, n), eta (H+1, n))."""
    elems = _lqt_elements(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat,
                          r_vec, m_mat, p_term, p_vec_term)
    combined = jax.lax.associative_scan(
        lambda a, b: _combine_v(b, a), elems, reverse=True)
    _, _, _, eta, j = combined
    return j, eta


def _lqt_elements(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat, r_vec,
                  m_mat, p_term, p_vec_term):
    """Per-stage conditional value elements for the general LQT (H+1
    entries; the last is the terminal cost)."""
    h, n, _ = f_mat.shape
    r_inv = jnp.linalg.inv(r_mat)
    ri_m = r_inv @ m_mat
    ri_r = (r_inv @ r_vec[..., None])[..., 0]
    mt = jnp.swapaxes(m_mat, -1, -2)
    q_t = q_mat - mt @ ri_m
    qv_t = q_vec - (mt @ ri_r[..., None])[..., 0]
    f_t = f_mat - l_mat @ ri_m
    c_t = c_vec - (l_mat @ ri_r[..., None])[..., 0]
    c_elem = l_mat @ r_inv @ jnp.swapaxes(l_mat, -1, -2)
    return (
        jnp.concatenate([f_t, jnp.zeros((1, n, n), f_mat.dtype)]),
        jnp.concatenate([c_t, jnp.zeros((1, n), f_mat.dtype)]),
        jnp.concatenate([c_elem, jnp.zeros((1, n, n), f_mat.dtype)]),
        jnp.concatenate([-qv_t, -p_vec_term[None]]),
        jnp.concatenate([q_t, p_term[None]]),
    )


def _identity_elements(k: int, n: int, dtype) -> tuple:
    """k identity elements: combine(e, id) == e == combine(id, e)."""
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (k, n, n))
    zmat = jnp.zeros((k, n, n), dtype)
    zvec = jnp.zeros((k, n), dtype)
    return (eye, zvec, zmat, zvec, zmat)


def lqt_backward_parallel_sharded(f_mat, l_mat, c_vec, q_mat, q_vec,
                                  r_mat, r_vec, m_mat, p_term,
                                  p_vec_term, mesh: Mesh,
                                  axis: str = "sp",
                                  gather_output: bool = True):
    """Horizon-distributed parallel LQT backward (SURVEY.md §7 hard
    part 4 — the long-context analogue).

    The H+1 value elements shard over mesh axis `axis` (the time axis
    is the "sequence").  Three-phase block scan:

      1. each device runs the log-depth suffix scan over its local
         chunk of the horizon,
      2. one `all_gather` over `axis` exchanges the n_dev chunk-total
         elements (a few (n,n) matrices each — tiny on ICI),
      3. every device combines the suffix of *later* chunks into its
         local results (one batched combine).

    *Algorithmic* communication is exactly one all_gather of n_dev
    elements, independent of H (asserted on compiled HLO by
    tests/test_collective_volume.py).  Returns (P (H+1, n, n),
    eta (H+1, n)), identical (to fp) to lqt_backward_parallel.

    gather_output=True (default) replicates the result — that output
    all_gather is the unavoidable cost of handing every host the full
    value trajectory.  Pass gather_output=False inside a
    horizon-sharded pipeline to keep P/eta sharded over `axis`
    (returned at padded length ceil((H+1)/n_dev)*n_dev; entries past
    H+1 are identity padding) so downstream per-timestep consumers
    (gains, rollouts) stay local to their horizon chunk."""
    h = f_mat.shape[0]
    n = f_mat.shape[1]
    n_dev = mesh.shape[axis]
    elems = _lqt_elements(f_mat, l_mat, c_vec, q_mat, q_vec, r_mat,
                          r_vec, m_mat, p_term, p_vec_term)
    total = h + 1
    pad = (-total) % n_dev
    if pad:
        # Identity padding sits *after* the terminal element; suffix
        # combines that include it are unchanged.
        ident = _identity_elements(pad, n, f_mat.dtype)
        elems = tuple(jnp.concatenate([e, i]) for e, i in
                      zip(elems, ident))
    # Element construction is cheap elementwise math on replicated
    # inputs; pin it replicated so GSPMD doesn't shard it backward
    # from the shard_map in_specs and then reshard around the padding
    # concatenate with H-sized all-gathers.  Replicated -> P(axis) at
    # the shard_map boundary is a free local slice; the ONE chunk-total
    # all_gather inside `body` stays the only real communication
    # (asserted by tests/test_collective_volume.py).
    from jax.sharding import NamedSharding
    elems = tuple(jax.lax.with_sharding_constraint(
        e, NamedSharding(mesh, P())) for e in elems)

    def body(local):
        # 1. local suffix scan (reverse): out[i] = e_i ⊕ ... ⊕ e_last.
        local_suffix = jax.lax.associative_scan(
            lambda a, b: _combine_v(b, a), local, reverse=True)
        chunk_total = jax.tree.map(lambda x: x[0], local_suffix)
        # 2. exchange chunk totals.
        gathered = jax.lax.all_gather(chunk_total, axis)
        # 3. suffix-combine the *later* chunks: R_j = T_j ⊕ ... ⊕ T_end,
        #    then my tail element is R_{i+1} (identity for the last).
        tails = jax.lax.associative_scan(
            lambda a, b: _combine_v(b, a), gathered, reverse=True)
        ident = jax.tree.map(lambda x: x[0],
                             _identity_elements(1, n, f_mat.dtype))
        tails = jax.tree.map(
            lambda t, i: jnp.concatenate([t, i[None]]), tails, ident)
        i_dev = jax.lax.axis_index(axis)
        my_tail = jax.tree.map(lambda t: t[i_dev + 1], tails)
        my_tail_b = jax.tree.map(
            lambda t, ls: jnp.broadcast_to(t, ls.shape),
            my_tail, local_suffix)
        return _combine_v(local_suffix, my_tail_b)

    spec = (P(axis), P(axis), P(axis), P(axis), P(axis))
    combined = jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                             out_specs=spec)(elems)
    _, _, _, eta, j = combined
    if not gather_output:
        return j, eta
    return j[:total], eta[:total]


def lqt_gains(f_mat, l_mat, c_vec, r_mat, r_vec, m_mat, p_next,
              eta_next):
    """Feedback/feedforward gains for the general LQT from the
    next-step value function (P_{k+1}, eta_{k+1}): u_k = -K x_k - k_k.

        quu = R + L'P⁺L
        K   = quu^{-1} (M + L'P⁺F)
        k   = quu^{-1} (r + L'(P⁺c - eta⁺))
    """
    lt = jnp.swapaxes(l_mat, -1, -2)
    quu = r_mat + lt @ p_next @ l_mat
    k_fb = jnp.linalg.solve(quu, m_mat + lt @ p_next @ f_mat)
    rhs = r_vec[..., None] + lt @ (p_next @ c_vec[..., None]
                                   - eta_next[..., None])
    k_ff = jnp.linalg.solve(quu, rhs)[..., 0]
    return k_fb, k_ff


def lqr_solve_parallel(f_mat, l_mat, c_vec, x_cost, u_cost, x_terminal,
                       x0):
    """Full parallel LQR solve: returns (xs (H+1, n), us (H, m)).

    All heavy math is the log-depth associative scan plus one batched
    gains solve; the final rollout is the only sequential part."""
    p_all, eta_all = lqr_backward_parallel(f_mat, l_mat, c_vec, x_cost,
                                           u_cost, x_terminal)
    k_fb, k_ff = lqr_gains_from_value(f_mat, l_mat, c_vec, u_cost,
                                      p_all[1:], eta_all[1:])

    def step(x, inp):
        f_t, l_t, c_t, kfb_t, kff_t = inp
        u = -(kfb_t @ x) - kff_t
        x_next = f_t @ x + l_t @ u + c_t
        return x_next, (x, u)

    _, (xs, us) = jax.lax.scan(step, x0,
                               (f_mat, l_mat, c_vec, k_fb, k_ff))
    xs = jnp.concatenate([xs[1:], (f_mat[-1] @ xs[-1]
                                   + l_mat[-1] @ us[-1]
                                   + c_vec[-1])[None]], axis=0)
    xs = jnp.concatenate([x0[None], xs], axis=0)
    return xs, us
