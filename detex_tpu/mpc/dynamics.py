"""Visual-latent dynamics model: conv encoder + residual MLP dynamics.

New component (no reference counterpart).  The encoder maps
decoded RGBA8 observations (from the batched block decoders) into a
latent state z; the dynamics model predicts z' = f(z, u).  Everything
is plain jax pytrees + optax, designed to shard:

  * batch axis       -> mesh axis "dp"
  * hidden features  -> mesh axis "tp" (matmuls column/row sharded)

bfloat16 compute (tensor cores on the GPU), float32 params/optimizer
state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    image_size: int = 64           # observations are image_size x image_size
    channels: int = 4              # decoded RGBA8
    conv_features: Tuple[int, ...] = (32, 64, 128, 256)
    latent_dim: int = 128
    action_dim: int = 8
    hidden_dim: int = 512
    n_dynamics_layers: int = 2
    compute_dtype: Any = jnp.bfloat16


def _conv_init(key, k, c_in, c_out):
    scale = np.sqrt(2.0 / (k * k * c_in))
    return jax.random.normal(key, (k, k, c_in, c_out), jnp.float32) * scale


def _dense_init(key, d_in, d_out):
    scale = np.sqrt(2.0 / d_in)
    return jax.random.normal(key, (d_in, d_out), jnp.float32) * scale


def init_params(key, cfg: DynamicsConfig) -> Dict:
    """Initialize encoder + dynamics parameters (pytree of f32)."""
    keys = jax.random.split(key, 16)
    params: Dict[str, Any] = {"enc": {}, "dyn": {}}
    c_in = cfg.channels
    size = cfg.image_size
    for i, c_out in enumerate(cfg.conv_features):
        params["enc"][f"conv{i}"] = {
            "w": _conv_init(keys[i], 3, c_in, c_out),
            "b": jnp.zeros((c_out,), jnp.float32)}
        c_in = c_out
        size //= 2
    flat = size * size * c_in
    params["enc"]["proj"] = {
        "w": _dense_init(keys[8], flat, cfg.latent_dim),
        "b": jnp.zeros((cfg.latent_dim,), jnp.float32)}
    d_in = cfg.latent_dim + cfg.action_dim
    for i in range(cfg.n_dynamics_layers):
        params["dyn"][f"fc{i}"] = {
            "w": _dense_init(keys[10 + i], d_in, cfg.hidden_dim),
            "b": jnp.zeros((cfg.hidden_dim,), jnp.float32)}
        d_in = cfg.hidden_dim
    params["dyn"]["out"] = {
        "w": _dense_init(keys[14], d_in, cfg.latent_dim),
        "b": jnp.zeros((cfg.latent_dim,), jnp.float32)}
    return params


def param_shardings(mesh: Mesh, cfg: DynamicsConfig) -> Dict:
    """Tensor-parallel shardings: conv output channels and MLP hidden
    dims split over "tp"; biases follow; small tensors replicated."""
    def conv_spec(i):
        return {"w": NamedSharding(mesh, P(None, None, None, "tp")),
                "b": NamedSharding(mesh, P("tp"))}

    enc = {f"conv{i}": conv_spec(i)
           for i in range(len(cfg.conv_features))}
    enc["proj"] = {"w": NamedSharding(mesh, P("tp", None)),
                   "b": NamedSharding(mesh, P())}
    dyn = {}
    for i in range(cfg.n_dynamics_layers):
        dyn[f"fc{i}"] = {"w": NamedSharding(mesh, P(None, "tp")),
                         "b": NamedSharding(mesh, P("tp"))}
    dyn["out"] = {"w": NamedSharding(mesh, P("tp", None)),
                  "b": NamedSharding(mesh, P())}
    return {"enc": enc, "dyn": dyn}


def encode(params: Dict, obs: jnp.ndarray,
           cfg: DynamicsConfig) -> jnp.ndarray:
    """(B, H, W, C) uint8/float observations -> (B, latent) float32."""
    x = obs.astype(cfg.compute_dtype)
    if obs.dtype == jnp.uint8 or obs.dtype == jnp.int32:
        x = x * jnp.asarray(1.0 / 255.0, cfg.compute_dtype)
    for i in range(len(cfg.conv_features)):
        p = params["enc"][f"conv{i}"]
        # Conv runs fully in the compute dtype: mixing bf16 operands
        # with a f32 preferred type breaks the conv transpose rule
        # under autodiff.
        x = jax.lax.conv_general_dilated(
            x, p["w"].astype(cfg.compute_dtype),
            window_strides=(2, 2), padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        x = jax.nn.relu(x + p["b"].astype(cfg.compute_dtype))
    x = x.reshape(x.shape[0], -1)
    p = params["enc"]["proj"]
    z = jnp.dot(x, p["w"].astype(cfg.compute_dtype),
                preferred_element_type=jnp.float32) + p["b"]
    return z.astype(jnp.float32)


def dynamics_apply(params: Dict, z: jnp.ndarray, u: jnp.ndarray,
                   cfg: DynamicsConfig) -> jnp.ndarray:
    """Residual latent dynamics: z' = z + MLP([z, u])."""
    x = jnp.concatenate([z, u], axis=-1).astype(cfg.compute_dtype)
    for i in range(cfg.n_dynamics_layers):
        p = params["dyn"][f"fc{i}"]
        x = jnp.dot(x, p["w"].astype(cfg.compute_dtype),
                    preferred_element_type=jnp.float32) + p["b"]
        x = jax.nn.relu(x).astype(cfg.compute_dtype)
    p = params["dyn"]["out"]
    dz = jnp.dot(x, p["w"].astype(cfg.compute_dtype),
                 preferred_element_type=jnp.float32) + p["b"]
    return z + dz.astype(jnp.float32)


def loss_fn(params: Dict, batch: Dict, cfg: DynamicsConfig) -> jnp.ndarray:
    """Latent one-step prediction loss.

    batch: obs (B,H,W,C), action (B,A), next_obs (B,H,W,C)."""
    z = encode(params, batch["obs"], cfg)
    z_next = encode(params, batch["next_obs"], cfg)
    z_pred = dynamics_apply(params, z, batch["action"], cfg)
    err = z_pred - jax.lax.stop_gradient(z_next)
    # Latent regularizer keeps the encoder from collapsing to zero.
    reg = jnp.mean(jnp.square(jnp.mean(jnp.square(z), axis=-1) - 1.0))
    return jnp.mean(jnp.sum(jnp.square(err), axis=-1)) + 0.01 * reg


def make_optimizer(lr: float = 3e-4):
    return optax.adamw(lr, weight_decay=1e-5)


def train_step(params, opt_state, batch, cfg: DynamicsConfig,
               optimizer=None):
    """One SGD step; jit/pjit-able.  Gradients mean-reduce over the dp
    axis automatically via sharded batch + replicated params."""
    optimizer = optimizer or make_optimizer()
    loss, grads = jax.value_and_grad(loss_fn)(params, batch, cfg)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss
