"""Visual-MPC runtime: fused decode -> encode -> plan control step.

The north-star architecture (BASELINE.md): observations arrive as
compressed BC7 texture blocks; one jitted step decodes them in-HBM with
the batched block decoder, encodes to the latent, and runs MPPI (with
optional iLQR refinement) — no host round-trip inside the step.

Multi-chip: the MPPI rollout batch shards over the mesh "dp" axis and
the dynamics matmuls over "tp"; the same jitted step runs on any mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from detex_tpu import formats as F
from detex_tpu.mpc import dynamics as D
from detex_tpu.mpc import ilqr as ilqr_mod
from detex_tpu.mpc import mppi as mppi_mod
from detex_tpu import engine


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    dynamics: D.DynamicsConfig = D.DynamicsConfig()
    mppi: mppi_mod.MPPIConfig = mppi_mod.MPPIConfig()
    obs_format: int = F.BPTC
    n_ilqr_iterations: int = 0     # 0 disables iLQR refinement
    ilqr_parallel: bool = False    # log-depth parallel-LQT backward
    goal_weight: float = 1.0
    control_weight: float = 0.1
    # Mesh axis to shard the MPPI rollout batch over (None = single
    # device).  With a mesh passed to control_step the rollouts run
    # under an explicit shard_map + psum; without one, GSPMD pins the
    # batch via with_sharding_constraint (ambient mesh required).
    rollout_axis: Optional[str] = None


def unpack_rgba8_image(packed: jnp.ndarray, height: int,
                       width: int) -> jnp.ndarray:
    """(N_blocks, 16) packed RGBA8 int32 -> (H, W, 4) int32 0..255.

    The tiled->linear relayout is four strided row-slices + concat."""
    hb, wb = height // 4, width // 4
    x = packed.reshape(hb, wb, 4, 4)
    rows = [x[:, :, py, :].reshape(hb, 1, wb * 4) for py in range(4)]
    img = jnp.concatenate(rows, axis=1).reshape(height, width)
    r = jnp.bitwise_and(img, 0xFF)
    g = jnp.bitwise_and(img >> 8, 0xFF)
    b = jnp.bitwise_and(img >> 16, 0xFF)
    a = jnp.bitwise_and(img >> 24, 0xFF)
    return jnp.stack([r, g, b, a], axis=-1)


def decode_obs(words: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """BC7 block words (N, 4) -> (H, W, 4) uint8-valued image, in-graph
    (the engine decoder table's BC7 entry)."""
    pix, _ = engine.device_decoder(F.BPTC)(words)
    return unpack_rgba8_image(pix, height, width)


def unpack_rgba8_images(packed: jnp.ndarray, height: int,
                        width: int) -> jnp.ndarray:
    """Batched unpack_rgba8_image: (B, N_blocks, 16) packed RGBA8
    int32 -> (B, H, W, 4) int32 0..255 (same strided row-slice+concat
    relayout)."""
    b = packed.shape[0]
    hb, wb = height // 4, width // 4
    x = packed.reshape(b, hb, wb, 4, 4)
    rows = [x[:, :, :, py, :].reshape(b, hb, 1, wb * 4)
            for py in range(4)]
    img = jnp.concatenate(rows, axis=2).reshape(b, height, width)
    r = jnp.bitwise_and(img, 0xFF)
    g = jnp.bitwise_and(img >> 8, 0xFF)
    bl = jnp.bitwise_and(img >> 16, 0xFF)
    a = jnp.bitwise_and(img >> 24, 0xFF)
    return jnp.stack([r, g, bl, a], axis=-1)


def decode_obs_batch(words: jnp.ndarray, height: int,
                     width: int) -> jnp.ndarray:
    """Batched in-graph BC7 observation decode: (B, N_blocks, 4)
    words -> (B, H, W, 4) int32 images.  The SAME decode code as the
    control step's decode_obs — training and control share the
    perception path (BASELINE north star)."""
    b, nb, _ = words.shape
    pix, _ = engine.device_decoder(F.BPTC)(words.reshape(b * nb, 4))
    return unpack_rgba8_images(pix.reshape(b, nb, 16), height, width)


def latent_cost_fn(goal_z: jnp.ndarray, cfg: ControllerConfig):
    """Quadratic latent-goal cost for the planner."""
    def cost(z, u, t):
        return (cfg.goal_weight * jnp.sum((z - goal_z[None]) ** 2, axis=-1)
                + cfg.control_weight * jnp.sum(u ** 2, axis=-1))
    return cost


def control_step(params, nominal, key, obs_words, goal_z,
                 cfg: ControllerConfig, mesh=None):
    """One full control step (jit this, donate `nominal`):

    decode BC7 obs -> encode -> MPPI update -> (optional iLQR) ->
    (action u_0, shifted nominal, diagnostics).

    mesh: optional jax.sharding.Mesh — with cfg.rollout_axis set, the
    MPPI rollout batch runs under an explicit shard_map over that axis
    (psum/pmin weight reduction across the devices)."""
    dcfg = cfg.dynamics
    img = decode_obs(obs_words, dcfg.image_size, dcfg.image_size)
    z0 = D.encode(params, img[None].astype(jnp.uint8), dcfg)[0]

    def dyn_batched(z, u):
        return D.dynamics_apply(params, z, u, dcfg)

    cost = latent_cost_fn(goal_z, cfg)
    new_nominal, diag = mppi_mod.mppi_step(
        key, nominal, z0, dyn_batched, cost, cfg.mppi,
        rollout_axis=cfg.rollout_axis, mesh=mesh)

    if cfg.n_ilqr_iterations > 0:
        def dyn1(x, u):
            return dyn_batched(x[None], u[None])[0]

        def cost1(x, u, t):
            return cost(x[None], u[None], t)[0]

        _, new_nominal, refined_cost = ilqr_mod.ilqr_solve(
            dyn1, cost1, lambda x: jnp.float32(0.0), z0, new_nominal,
            ilqr_mod.ILQRConfig(n_iterations=cfg.n_ilqr_iterations,
                                parallel=cfg.ilqr_parallel))
        diag = dict(diag, ilqr_cost=refined_cost)

    action = new_nominal[0]
    shifted = mppi_mod.receding_horizon_shift(new_nominal)
    return action, shifted, diag


class Controller:
    """Stateful convenience wrapper around the jitted control step."""

    def __init__(self, params, goal_z, cfg: ControllerConfig,
                 seed: int = 0, mesh=None):
        self.params = params
        self.goal_z = goal_z
        self.cfg = cfg
        self.key = jax.random.PRNGKey(seed)
        self.nominal = jnp.zeros(
            (cfg.mppi.horizon, cfg.mppi.action_dim), jnp.float32)
        self._step = jax.jit(
            functools.partial(control_step, cfg=cfg, mesh=mesh),
            donate_argnums=(1,))

    def step(self, obs_words) -> np.ndarray:
        self.key, sub = jax.random.split(self.key)
        action, self.nominal, self.diag = self._step(
            self.params, self.nominal, sub, obs_words, self.goal_z)
        return np.asarray(action)


class PipelinedController(Controller):
    """One-step software pipeline over the control loop (SURVEY §2.2
    PP row: decode -> encode -> rollout overlap).

    JAX dispatch is asynchronous: `_step(...)` enqueues the fused
    device program and returns immediately.  This controller exploits
    that by returning the action planned from the PREVIOUS
    observation: while the caller actuates it (and produces the next
    observation), the device is already decoding + planning on the
    current one — the obs upload, BC7 decode, encode, and rollouts all
    hide behind the consumer's own step time.  The returned action
    lags one control period, the standard latency/throughput trade of
    a pipelined controller; the plan itself is identical to the
    synchronous controller's (test_mpc asserts this).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending_action = None

    def step(self, obs_words) -> Optional[np.ndarray]:
        """Dispatch planning on `obs_words`; return the action from
        the previous observation (None on the first call — nothing is
        in flight yet)."""
        self.key, sub = jax.random.split(self.key)
        obs_dev = jax.device_put(obs_words)    # async H2D upload
        action, self.nominal, self.diag = self._step(
            self.params, self.nominal, sub, obs_dev, self.goal_z)
        prev, self._pending_action = self._pending_action, action
        # np.asarray blocks only until the *previous* step finished —
        # it has had a full control period of overlap to run.
        return None if prev is None else np.asarray(prev)

    def flush(self) -> Optional[np.ndarray]:
        """Drain the pipeline: block for the in-flight action."""
        prev, self._pending_action = self._pending_action, None
        return None if prev is None else np.asarray(prev)
