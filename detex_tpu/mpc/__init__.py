"""Sampling-MPC engine: visual-latent dynamics + MPPI + iLQR.

This subsystem has no reference counterpart (SURVEY.md §2.2): detex is
the perception front-end; the MPC engine is the new system
built on top of batched block decode.
"""

from detex_tpu.mpc.dynamics import (DynamicsConfig, dynamics_apply, encode,
                                    init_params, train_step)
from detex_tpu.mpc.mppi import MPPIConfig, mppi_step
from detex_tpu.mpc.ilqr import ilqr_solve

__all__ = [
    "DynamicsConfig", "init_params", "encode", "dynamics_apply",
    "train_step", "MPPIConfig", "mppi_step", "ilqr_solve",
]
