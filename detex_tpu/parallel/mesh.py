"""Device mesh construction and sharding helpers.

The reference has no distributed machinery at all (SURVEY.md §2.2); the
scaling model is a jax.sharding.Mesh with named axes:

  dp — data/rollout parallel (MPPI rollout batch, training batch)
  tp — tensor parallel (dynamics-model hidden dims)

Collectives stay on the device links within a host; a leading host
axis can be added by passing an explicit (n_hosts, ...) shape.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "tp")) -> Mesh:
    """Build a mesh over all available devices.

    Default: all devices on the dp axis, tp=1.  Pass an explicit shape
    (e.g. (2, 4)) to split between data and tensor parallelism.
    """
    devices = np.array(jax.devices())
    n = devices.size
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    return Mesh(devices.reshape(shape), axis_names)


def shard_batch(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Sharding for arrays whose leading axis is the batch."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def with_sharding(x, sharding: NamedSharding):
    return jax.lax.with_sharding_constraint(x, sharding)
