"""Two-process jax.distributed loopback test (SURVEY.md §4 point 5).

Spawns two real OS processes on this host, connects them through
jax.distributed (coordinator on localhost), builds the ('dcn', 'ici')
host mesh across both processes' CPU devices, runs two real
dynamics-model train steps over a globally-sharded batch, and asserts
the loss trajectory is identical across processes AND equal to the
single-process run of the same global computation.  No cluster
needed — this validates the multi-host runtime wiring
(parallel/distributed.py) end to end.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_COORDINATOR_ADDRESS", None)
sys.path.insert(0, {repo!r})

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from detex_tpu.parallel import distributed as dist

coord, pid = sys.argv[1], int(sys.argv[2])
dist.initialize(coordinator_address=coord, num_processes=2,
                process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

mesh = dist.make_host_mesh(axis_names=("dp", "tp"))
assert mesh.devices.shape == (2, 4)

from detex_tpu.mpc import dynamics as D
from detex_tpu.mpc.train_loop import (SyntheticVisualEnv, TrainConfig,
                                      make_train_step)

# North-star data path: observations are BC7 blocks, decoded in-graph
# across the two-process mesh (VERDICT r2 item 5).
cfg = TrainConfig(compressed_obs=True)
dcfg = cfg.dynamics
env = SyntheticVisualEnv(dcfg, seed=0, compressed=True)
params = D.init_params(jax.random.PRNGKey(0), dcfg)
params = jax.device_put(params, D.param_shardings(mesh, dcfg))
opt = D.make_optimizer(cfg.lr)
opt_state = opt.init(params)

step_fn = make_train_step(dcfg, opt, compressed_obs=True)
batch_sharding = NamedSharding(mesh, P("dp"))

losses = []
with mesh:
    for step in range(2):
        rng = np.random.default_rng(np.random.SeedSequence([0, step]))
        batch = env.sample_batch(rng, cfg.batch_size)
        # Every process holds the full deterministic batch; each
        # contributes its addressable shards of the global array.
        gbatch = {{k: jax.make_array_from_callback(
            v.shape, batch_sharding, lambda idx, _v=v: _v[idx])
            for k, v in batch.items()}}
        params, opt_state, loss = step_fn(params, opt_state, gbatch)
        losses.append(float(loss))
print("LOSSES", repr(losses), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_loopback(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=str(REPO)))
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "JAX_COORDINATOR_ADDRESS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), coord, str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        outs.append(out)

    losses = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("LOSSES")]
        assert line, out
        import ast
        losses.append(ast.literal_eval(line[0].split(" ", 1)[1]))
    # Both processes observe the identical global loss trajectory.
    assert losses[0] == losses[1], losses

    # And it matches the single-process run of the same computation
    # (this pytest process has 8 virtual CPU devices: same mesh shape).
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from detex_tpu.mpc import dynamics as D
    from detex_tpu.mpc.train_loop import (SyntheticVisualEnv,
                                          TrainConfig, make_train_step)
    from detex_tpu.parallel import mesh as mesh_mod

    cfg = TrainConfig(compressed_obs=True)
    dcfg = cfg.dynamics
    mesh = mesh_mod.make_mesh((2, 4))
    env_ = SyntheticVisualEnv(dcfg, seed=0, compressed=True)
    params = D.init_params(jax.random.PRNGKey(0), dcfg)
    params = jax.device_put(params, D.param_shardings(mesh, dcfg))
    opt = D.make_optimizer(cfg.lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(dcfg, opt, compressed_obs=True)
    ref = []
    with mesh:
        for step in range(2):
            rng = np.random.default_rng(np.random.SeedSequence([0, step]))
            batch = env_.sample_batch(rng, cfg.batch_size)
            batch = {k: jax.device_put(v, NamedSharding(mesh, P("dp")))
                     for k, v in batch.items()}
            params, opt_state, loss = step_fn(params, opt_state, batch)
            ref.append(float(loss))
    np.testing.assert_allclose(losses[0], ref, rtol=1e-5)


# --- hierarchical ('dcn', 'ici') two-process loopback (VERDICT r3 #4) ---
# 2 processes x 4 local virtual devices; 'dcn' = the process axis (every
# 'dcn' row is owned by one process, so DCN collectives really cross the
# process boundary).  Runs the compressed-obs train step AND the sharded
# MPPI control step, asserts loss/plan equality with the single-process
# hierarchical run, and asserts ICI-first psum from the compiled HLO.

_WORKER_HIER = r'''
import functools, os, re, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_COORDINATOR_ADDRESS", None)
sys.path.insert(0, "@REPO@")

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from detex_tpu.parallel import distributed as dist

coord, pid = sys.argv[1], int(sys.argv[2])
dist.initialize(coordinator_address=coord, num_processes=2,
                process_id=pid)
assert jax.process_count() == 2, jax.process_count()
mesh = dist.make_host_mesh(axis_names=("dcn", "ici"))
assert mesh.devices.shape == (2, 4), mesh.devices.shape
# Each 'dcn' row must belong to exactly one process: the outer axis IS
# the process (DCN) boundary, the inner axis stays process-local (ICI).
for p in range(2):
    assert all(d.process_index == p for d in mesh.devices[p]), \
        [(d.id, d.process_index) for d in mesh.devices.ravel()]

from detex_tpu.mpc import dynamics as D
from detex_tpu.mpc.train_loop import (SyntheticVisualEnv, TrainConfig,
                                      make_train_step)

cfg = TrainConfig(compressed_obs=True)
dcfg = cfg.dynamics
env = SyntheticVisualEnv(dcfg, seed=0, compressed=True)
params = D.init_params(jax.random.PRNGKey(0), dcfg)
params = jax.device_put(params, jax.tree.map(
    lambda _: NamedSharding(mesh, P()), params))
opt = D.make_optimizer(cfg.lr)
opt_state = opt.init(params)
step_fn = make_train_step(dcfg, opt, compressed_obs=True)
# Batch sharded over BOTH axes: all 8 devices hold 1/8 of the batch.
batch_sharding = NamedSharding(mesh, P(("dcn", "ici")))

losses = []
with mesh:
    for step in range(2):
        rng = np.random.default_rng(np.random.SeedSequence([0, step]))
        batch = env.sample_batch(rng, cfg.batch_size)
        gbatch = {k: jax.make_array_from_callback(
            v.shape, batch_sharding, lambda idx, _v=v: _v[idx])
            for k, v in batch.items()}
        params, opt_state, loss = step_fn(params, opt_state, gbatch)
        losses.append(float(loss))
print("LOSSES", repr(losses), flush=True)

# Sharded MPPI control step over the hierarchical rollout axes.
from detex_tpu.mpc import mppi as M
from detex_tpu.mpc.runtime import ControllerConfig, control_step

ccfg = ControllerConfig(
    dynamics=dcfg,
    mppi=M.MPPIConfig(n_rollouts=128, horizon=8,
                      action_dim=dcfg.action_dim),
    rollout_axis=("dcn", "ici"))
wrng = np.random.default_rng(7)
n_blocks = (dcfg.image_size // 4) ** 2
obs_words = jnp.asarray(
    wrng.integers(-2**31, 2**31, (n_blocks, 4), np.int64)
    .astype(np.int32))
nominal = jnp.zeros((8, dcfg.action_dim), jnp.float32)
goal_z = jnp.zeros((dcfg.latent_dim,), jnp.float32)
cstep = jax.jit(functools.partial(control_step, cfg=ccfg, mesh=mesh))
with mesh:
    action, shifted, diag = cstep(params, nominal, jax.random.PRNGKey(3),
                                  obs_words, goal_z)
    jax.block_until_ready(action)
print("ACTION", repr([float(x) for x in np.asarray(action)]), flush=True)

# ICI-first reduction witness from the compiled HLO: the within-process
# groups {{0,1,2,3},{4,5,6,7}} (ICI) and the cross-process groups
# {{0,4},{1,5},{2,6},{3,7}} (DCN, carrying only the O(H*A) partial)
# must BOTH appear among the all-reduce replica groups.
txt = cstep.lower(params, nominal, jax.random.PRNGKey(3), obs_words,
                  goal_z).compile().as_text()
groups = set(re.findall(r"all-reduce[^\n]*replica_groups=(\{\{[0-9,{}]*\}\})",
                        txt))
assert "{{0,1,2,3},{4,5,6,7}}" in groups, groups
assert "{{0,4},{1,5},{2,6},{3,7}}" in groups, groups
print("HLO_HIER_OK", flush=True)
'''


def test_two_process_hierarchical_loopback(tmp_path):
    worker = tmp_path / "worker_hier.py"
    worker.write_text(_WORKER_HIER.replace("@REPO@", str(REPO)))
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "JAX_COORDINATOR_ADDRESS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), coord, str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        outs.append(out)

    import ast
    losses, actions = [], []
    for out in outs:
        lines = out.splitlines()
        lline = [ln for ln in lines if ln.startswith("LOSSES")]
        aline = [ln for ln in lines if ln.startswith("ACTION")]
        assert lline and aline, out
        assert any(ln.startswith("HLO_HIER_OK") for ln in lines), out
        losses.append(ast.literal_eval(lline[0].split(" ", 1)[1]))
        actions.append(ast.literal_eval(aline[0].split(" ", 1)[1]))
    # Both processes observe identical global results.
    assert losses[0] == losses[1], losses
    assert actions[0] == actions[1], actions

    # Single-process hierarchical run of the SAME computation (this
    # pytest process has 8 virtual devices: same (2, 4) mesh shape).
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from detex_tpu.mpc import dynamics as D
    from detex_tpu.mpc import mppi as M
    from detex_tpu.mpc.runtime import ControllerConfig, control_step
    from detex_tpu.mpc.train_loop import (SyntheticVisualEnv,
                                          TrainConfig, make_train_step)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("dcn", "ici"))
    cfg = TrainConfig(compressed_obs=True)
    dcfg = cfg.dynamics
    env_ = SyntheticVisualEnv(dcfg, seed=0, compressed=True)
    params = D.init_params(jax.random.PRNGKey(0), dcfg)
    params = jax.device_put(params, jax.tree.map(
        lambda _: NamedSharding(mesh, P()), params))
    opt = D.make_optimizer(cfg.lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(dcfg, opt, compressed_obs=True)
    ref = []
    with mesh:
        for step in range(2):
            rng = np.random.default_rng(np.random.SeedSequence([0, step]))
            batch = env_.sample_batch(rng, cfg.batch_size)
            batch = {k: jax.device_put(
                v, NamedSharding(mesh, P(("dcn", "ici"))))
                for k, v in batch.items()}
            params, opt_state, loss = step_fn(params, opt_state, batch)
            ref.append(float(loss))
    np.testing.assert_allclose(losses[0], ref, rtol=1e-5)

    ccfg = ControllerConfig(
        dynamics=dcfg,
        mppi=M.MPPIConfig(n_rollouts=128, horizon=8,
                          action_dim=dcfg.action_dim),
        rollout_axis=("dcn", "ici"))
    wrng = np.random.default_rng(7)
    n_blocks = (dcfg.image_size // 4) ** 2
    obs_words = jnp.asarray(
        wrng.integers(-2**31, 2**31, (n_blocks, 4), np.int64)
        .astype(np.int32))
    nominal = jnp.zeros((8, dcfg.action_dim), jnp.float32)
    goal_z = jnp.zeros((dcfg.latent_dim,), jnp.float32)
    cstep = jax.jit(functools.partial(control_step, cfg=ccfg, mesh=mesh))
    with mesh:
        action, _, _ = cstep(params, nominal, jax.random.PRNGKey(3),
                             obs_words, goal_z)
        jax.block_until_ready(action)
    np.testing.assert_allclose(actions[0], np.asarray(action), rtol=1e-5)
