"""Multi-host runtime: jax.distributed init + a two-level host mesh.

The reference has no distributed machinery (SURVEY.md §2.2); the
scaling model is:

  * one process per host, connected with jax.distributed.initialize()
  * a 2D ('dcn', 'ici') mesh — the leading axis spans hosts (traffic
    between hosts crosses the network), the trailing axis spans the
    devices within a host (traffic stays on the host's device links)
  * collectives are XLA psum/all_gather/ppermute emitted by pjit or
    shard_map; no custom transport anywhere

Shardings should keep heavy reductions (MPPI weight normalization,
Riccati combines) within a host and only cross hosts for the final
small reduce (BASELINE.md >=90% two-host scaling target).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Connect this process to the multi-host runtime.

    No-ops when running single-process with no coordinator configured
    (so the same entrypoint works on one host and many).  Arguments
    default to the standard JAX env vars."""
    if (coordinator_address is None and num_processes is None
            and "JAX_COORDINATOR_ADDRESS" not in os.environ
            and "COORDINATOR_ADDRESS" not in os.environ):
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_host_mesh(axis_names: Sequence[str] = ("dcn", "ici"),
                   devices=None) -> Mesh:
    """Mesh with hosts on the leading axis and each host's devices on
    the trailing axis.

    With a single process this degenerates to (1, n_devices) — the same
    program shape runs anywhere."""
    devices = list(devices) if devices is not None else jax.devices()
    n_hosts = max(1, jax.process_count())
    per_host = len(devices) // n_hosts
    grid = np.array(devices).reshape(n_hosts, per_host)
    return Mesh(grid, axis_names)
