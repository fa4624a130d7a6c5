#!/usr/bin/env python3
"""Smoke run of dtx on an NVIDIA GPU, through the entry points a user
calls, at the north-star widths.

    python chip_smoke.py                # phases 0-4 on one card
    python chip_smoke.py --four-cards   # the sharded paths on 4 cards,
                                        # each against the one-card run

Phases (one process; any failure exits non-zero):
  0  device check: JAX's first device must be a GPU (no CPU fallback);
     prints device kind, count and `nvidia-smi` name + power limit.
  1  decode: 2^22 random blocks of each of the 19 families through
     engine.decode_blocks_device, bit-exact vs the native C++ oracle
     (pixels of valid blocks + the valid mask), plus one mode-mask /
     flags variant per family.
  2  fused texture pipeline: decompress_texture_linear(backend="device")
     on a 4096x4096 texture per family (default pixel format, + BGRA8
     for the packed-RGBA8 families) and on odd-size textures, bit-exact
     vs backend="native"; LAST_BACKEND must say "device".
  3  control step at ControllerConfig() defaults (64x64 BC7 obs, bf16,
     MPPI 8192x32x8), iLQR 0 and 2, Controller + PipelinedController,
     20 steps each; f32 reference at matmul precision "highest" on the
     GPU and on the CPU.
  4  train: mpc.train_loop.train for 5 steps, default DynamicsConfig,
     batch 256 of BC7 observations decoded in-graph; step-1 loss vs the
     CPU f32 step.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import dataclasses
import io
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

N_DECODE = 1 << 22
TEX_SIDE = 4096
ODD_SIZE = (4093, 4091)
# One odd-size texture per packer kind (u32, p8, p8x2, p16, p16x2,
# p16x4); the CPU tests cover every family at odd sizes.
ODD_FAMILIES = ("BPTC", "RGTC1", "RGTC2", "EAC_SIGNED_R11", "EAC_RG11",
                "BPTC_FLOAT")
CONTROL_STEPS = 20
TRAIN_STEPS = 5
TRAIN_BATCH = 256

# f32 at matmul precision "highest" on the GPU vs the CPU: the same
# arithmetic in another summation order, so agreement to ~1e-6 relative
# on costs; actions are MPPI weighted means of clipped controls in
# [-1, 1].
ACTION_ATOL_F32 = 1e-3
COST_RTOL_F32 = 1e-4
LOSS_RTOL_F32 = 1e-3
# bf16 compute vs the f32 reference: bf16 keeps 8 significant bits, and
# the encoder (4 convs + projection) and 32 dynamics steps compound the
# rounding, so costs and the loss agree only to a few per cent.  At
# temperature 1 MPPI is close to an argmin over rollouts (ESS printed),
# so bf16 may rank another rollout first: actions are held to their
# bounds, not to the f32 actions.
COST_RTOL_BF16 = 5e-2
LOSS_RTOL_BF16 = 5e-2
# Controller vs PipelinedController: the same program compiled twice.
PIPELINE_ATOL = 1e-5


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def require_gpu(devices):
    """The first JAX device must be a GPU; returns it."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise SmokeFailure(f"no GPU: JAX's first device is {platform!r}")
    return devices[0]


def compare_decode(family, got, got_valid, want, want_valid):
    """Bit-exact compare of decoded payload bytes: the valid masks must
    be equal, and the pixels of every valid block (the oracle
    zero-fills invalid ones)."""
    got_valid = np.asarray(got_valid, bool)
    want_valid = np.asarray(want_valid, bool)
    check(got.shape == want.shape,
          f"{family}: shape {got.shape} != oracle {want.shape}")
    n_bad_valid = int(np.sum(got_valid != want_valid))
    check(n_bad_valid == 0,
          f"{family}: valid mask differs on {n_bad_valid} blocks")
    bad = np.nonzero(np.any(got[want_valid] != want[want_valid], axis=1))[0]
    check(bad.size == 0,
          f"{family}: {bad.size} of {int(want_valid.sum())} valid blocks "
          f"differ from the oracle")


def phases(four_cards: bool):
    return (("four_cards",) if four_cards
            else ("decode", "texture", "control", "train"))


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_decode(seed):
    import jax
    import jax.numpy as jnp

    from detex_tpu import engine, native
    from detex_tpu import formats as F
    from detex_tpu.ops.bitops import words_from_bytes
    from detex_tpu.utils.blocks import FAMILIES, random_blocks, \
        texture_format
    check(native.available(), "native oracle did not build")
    rng = np.random.default_rng(seed)
    flags_cycle = (F.FLAG_ENCODE, F.FLAG_OPAQUE_ONLY, F.FLAG_NON_OPAQUE_ONLY)
    for i, fam in enumerate(FAMILIES):
        fmt = texture_format(fam)
        blocks = random_blocks(rng, fam, N_DECODE)
        words = jax.device_put(words_from_bytes(blocks))
        t0 = time.perf_counter()
        jax.block_until_ready(engine.decode_blocks_device(fmt, words))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(engine.decode_blocks_device(fmt, words))
        steady = time.perf_counter() - t0
        for mask, flags in ((0xFFFFFFFF, 0),
                            (0x55555555, flags_cycle[i % 3])):
            got, got_valid = engine.decode_blocks(fmt, blocks, mask, flags,
                                                  backend="jax")
            want, want_valid = native.decode(fam, blocks, mask, flags)
            compare_decode(f"{fam} mask={mask:#x} flags={flags}", got,
                           got_valid, want, want_valid)
        dec = engine.device_decoder(fmt)
        note = ""
        if hasattr(dec, "gpu_kernel"):
            # The compiled Triton kernel, not the interpreter, and equal
            # to the plain jnp decoder it replaces.
            args = (words, np.uint32(0xFFFFFFFF), np.uint32(0))
            hlo = jax.jit(dec).lower(*args).as_text()
            check("__gpu$xla.gpu.triton" in hlo,
                  f"{fam}: no compiled Triton kernel in the decode")
            for a, b in zip(jax.jit(dec)(*args),
                            jax.jit(dec.fallback)(*args)):
                check(bool(jnp.array_equal(a, b)),
                      f"{fam}: kernel differs from its jnp decoder")
            note = "; kernel == jnp decoder"
        log(f"decode {fam}: {N_DECODE} blocks bit-exact vs native "
            f"(+ variant){note}; decoder={engine.decoder_name(fmt)}; "
            f"first call {first:.3f} s, steady {steady * 1e3:.3f} ms, "
            f"compile ~{first - steady:.3f} s")


def phase_texture(seed):
    from detex_tpu import engine
    from detex_tpu import formats as F
    from detex_tpu.texture import Texture
    from detex_tpu.utils.blocks import FAMILIES, random_blocks, \
        texture_format
    rng = np.random.default_rng(seed + 1)
    cases = []
    for fam in FAMILIES:
        fmt = texture_format(fam)
        targets = [F.texture_pixel_format(fmt)]
        if engine._DECODERS[F.compressed_index(fmt)][1] == "u32":
            targets.append(F.BGRA8)
        cases += [(fam, TEX_SIDE, TEX_SIDE, pf) for pf in targets]
    cases += [(fam, *ODD_SIZE, None) for fam in ODD_FAMILIES]
    for fam, w, h, pf in cases:
        fmt = texture_format(fam)
        n = ((w + 3) // 4) * ((h + 3) // 4)
        tex = Texture.new(fmt, random_blocks(rng, fam, n).reshape(-1), w, h)
        t0 = time.perf_counter()
        got = engine.decompress_texture_linear(tex, pf, backend="device")
        first = time.perf_counter() - t0
        check(engine.LAST_BACKEND == "device",
              f"{fam} {w}x{h}: ran on {engine.LAST_BACKEND!r}, not device")
        want = engine.decompress_texture_linear(tex, pf, backend="native")
        check(engine.LAST_BACKEND == "native", "native path not taken")
        check(got.shape == want.shape and np.array_equal(got, want),
              f"{fam} {w}x{h} -> {F.format_name(pf) if pf else 'default'}"
              f": device bytes differ from native "
              f"({int(np.sum(got != want)) if got.shape == want.shape else 'shape'})")
        log(f"texture {fam} {w}x{h} -> "
            f"{F.format_name(pf) if pf else 'default'}: bit-exact, "
            f"backend=device, first call (compile + run) {first:.3f} s")


def _controller_inputs(cfg, seed):
    import jax
    import jax.numpy as jnp

    from detex_tpu.mpc import dynamics as D
    from detex_tpu.utils.blocks import random_blocks
    params = D.init_params(jax.random.PRNGKey(seed), cfg.dynamics)
    rng = np.random.default_rng(seed)
    nb = (cfg.dynamics.image_size // 4) ** 2
    obs = random_blocks(rng, "BPTC", nb).view(np.uint32).view(np.int32)
    goal = jnp.asarray(rng.standard_normal(cfg.dynamics.latent_dim),
                       jnp.float32)
    return params, np.ascontiguousarray(obs), goal


def _f32(cfg):
    import jax.numpy as jnp
    return dataclasses.replace(cfg, dynamics=dataclasses.replace(
        cfg.dynamics, compute_dtype=jnp.float32))


def _one_step(cfg, params, obs, goal, seed, device=None, mesh=None):
    """First control step through Controller: (action, diag dict)."""
    import jax

    from detex_tpu.mpc.runtime import Controller
    with jax.default_device(device or jax.devices()[0]):
        if device is not None:
            params, obs, goal = jax.device_put((params, obs, goal), device)
        c = Controller(params, goal, cfg, seed=seed, mesh=mesh)
        action = c.step(obs)
    return action, {k: float(v) for k, v in c.diag.items()}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase_control(seed):
    import jax

    from detex_tpu.mpc.runtime import (Controller, ControllerConfig,
                                       PipelinedController)
    base = ControllerConfig()
    log(f"control config: {base}")
    for n_ilqr in (0, 2):
        cfg = dataclasses.replace(base, n_ilqr_iterations=n_ilqr)
        params, obs, goal = _controller_inputs(cfg, seed)
        c = Controller(params, goal, cfg, seed=seed)
        compiled = c._step.lower(params, c.nominal, c.key, obs,
                                 goal).compile()
        log(f"control ilqr={n_ilqr} memory_analysis: "
            f"{compiled.memory_analysis()}")
        t0 = time.perf_counter()
        actions = [c.step(obs)]
        first = time.perf_counter() - t0
        diag0 = {k: float(v) for k, v in c.diag.items()}
        times = []
        for _ in range(CONTROL_STEPS - 1):
            t0 = time.perf_counter()
            actions.append(c.step(obs))
            times.append(time.perf_counter() - t0)
        acts = np.stack(actions)
        check(acts.shape == (CONTROL_STEPS, cfg.mppi.action_dim),
              f"actions shape {acts.shape}")
        check(np.all(np.isfinite(acts)), "non-finite action")
        # MPPI's action is a convex combination of clipped controls;
        # iLQR refines it without box constraints.
        check(n_ilqr > 0 or np.all(np.abs(acts) <= cfg.mppi.action_high
                                   + 1e-6), "MPPI action outside bounds")
        p = PipelinedController(params, goal, cfg, seed=seed)
        lagged = [p.step(obs) for _ in range(CONTROL_STEPS)] + [p.flush()]
        check(lagged[0] is None, "pipelined controller's first step")
        pacts = np.stack(lagged[1:])
        dp = float(np.max(np.abs(pacts - acts)))
        check(dp <= PIPELINE_ATOL,
              f"PipelinedController differs from Controller by {dp}")
        log(f"control ilqr={n_ilqr} bf16: {CONTROL_STEPS} steps finite; "
            f"first call {first:.3f} s, steady median "
            f"{np.median(times) * 1e3:.3f} ms; diag {diag0}; pipelined "
            f"max |d| {dp:.3g} (tol {PIPELINE_ATOL})")
        stats = jax.devices()[0].memory_stats() or {}
        log(f"control ilqr={n_ilqr} peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use', 'not reported')}")

        cfg32 = _f32(cfg)
        with jax.default_matmul_precision("highest"):
            a_gpu, d_gpu = _one_step(cfg32, params, obs, goal, seed)
            a_cpu, d_cpu = _one_step(cfg32, params, obs, goal, seed,
                                     device=jax.devices("cpu")[0])
        da = float(np.max(np.abs(a_gpu - a_cpu)))
        dc = max(_rel(d_gpu[k], d_cpu[k]) for k in ("min_cost",
                                                     "mean_cost"))
        log(f"control ilqr={n_ilqr} f32 'highest' GPU vs CPU: max |d "
            f"action| {da:.3g} (tol {ACTION_ATOL_F32}), cost rel "
            f"{dc:.3g} (tol {COST_RTOL_F32}); GPU diag {d_gpu}")
        check(da <= ACTION_ATOL_F32, f"f32 action GPU vs CPU {da}")
        check(dc <= COST_RTOL_F32, f"f32 costs GPU vs CPU {dc}")
        db = max(_rel(diag0[k], d_cpu[k]) for k in ("min_cost",
                                                     "mean_cost"))
        log(f"control ilqr={n_ilqr} bf16 vs f32 CPU: cost rel {db:.3g} "
            f"(tol {COST_RTOL_BF16}); max |d action| "
            f"{float(np.max(np.abs(actions[0] - a_cpu))):.3g} (reported; "
            f"ESS bf16 {diag0['ess']:.3g})")
        check(db <= COST_RTOL_BF16, f"bf16 costs vs f32 {db}")


def _train_env(dcfg, seed):
    from detex_tpu.mpc.train_loop import CorpusReplayEnv
    return CorpusReplayEnv(dcfg, seed=seed, corpus_path=None)


def _train_losses(tcfg, env):
    """Run train_loop.train; returns {step: loss} from its metrics."""
    from detex_tpu.mpc.train_loop import train
    from detex_tpu.utils.metrics import MetricsLogger
    buf = io.StringIO()
    train(tcfg, MetricsLogger(buf), env)
    recs = [json.loads(x) for x in buf.getvalue().splitlines()]
    return {r["step"]: r["loss"] for r in recs}


def first_step_loss(dcfg, env, seed, batch_size, lr, device):
    """Step 0 of train_loop.train (same init, batch and optimizer) as
    one train step on `device`."""
    import jax

    from detex_tpu.mpc import dynamics as D
    from detex_tpu.mpc.train_loop import make_train_step
    with jax.default_device(device):
        params = D.init_params(jax.random.PRNGKey(seed), dcfg)
        opt = D.make_optimizer(lr)
        opt_state = opt.init(params)
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))
        batch = jax.device_put(env.sample_batch(rng, batch_size), device)
        step = make_train_step(dcfg, opt, compressed_obs=True)
        _, _, loss = step(params, opt_state, batch)
        return float(loss)


def phase_train(seed):
    import jax
    import jax.numpy as jnp

    from detex_tpu.mpc import dynamics as D
    from detex_tpu.mpc.train_loop import TrainConfig
    dcfg = D.DynamicsConfig()
    env = _train_env(dcfg, seed)
    tcfg = TrainConfig(dynamics=dcfg, batch_size=TRAIN_BATCH,
                       n_steps=TRAIN_STEPS, seed=seed, compressed_obs=True)
    t0 = time.perf_counter()
    losses = _train_losses(tcfg, env)
    wall = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in losses.values()),
          f"non-finite loss {losses}")
    check(set(losses) == {0, TRAIN_STEPS - 1}, f"logged steps {losses}")
    dcfg32 = dataclasses.replace(dcfg, compute_dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        gpu32 = _train_losses(dataclasses.replace(
            tcfg, dynamics=dcfg32, n_steps=1), env)[0]
        cpu32 = first_step_loss(dcfg32, env, seed, TRAIN_BATCH, tcfg.lr,
                                jax.devices("cpu")[0])
    r32, rbf = _rel(gpu32, cpu32), _rel(losses[0], cpu32)
    log(f"train {TRAIN_STEPS} steps bf16 batch {TRAIN_BATCH} (wall "
        f"{wall:.3f} s incl. compile): losses {losses}; step-1 loss f32 "
        f"'highest' GPU {gpu32:.6g} vs CPU {cpu32:.6g} rel {r32:.3g} (tol "
        f"{LOSS_RTOL_F32}); bf16 vs CPU f32 rel {rbf:.3g} (tol "
        f"{LOSS_RTOL_BF16})")
    check(r32 <= LOSS_RTOL_F32, f"f32 step-1 loss GPU vs CPU {r32}")
    check(rbf <= LOSS_RTOL_BF16, f"bf16 step-1 loss vs CPU f32 {rbf}")


def phase_four_cards(seed):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from detex_tpu import engine
    from detex_tpu import formats as F
    from detex_tpu.mpc import dynamics as D
    from detex_tpu.mpc.runtime import ControllerConfig
    from detex_tpu.mpc.train_loop import TrainConfig
    from detex_tpu.ops.bitops import words_from_bytes
    from detex_tpu.utils.blocks import random_blocks
    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = Mesh(np.array(devs[:4]), ("dp",))
    rep = NamedSharding(mesh, P())

    blocks = random_blocks(np.random.default_rng(seed), "BPTC", N_DECODE)
    words = words_from_bytes(blocks)
    one = engine.decode_blocks_device(F.BPTC, jax.device_put(words, devs[0]))
    four = engine.decode_blocks_sharded(F.BPTC, words, mesh)
    for a, b, what in zip(one, four, ("pixels", "valid")):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"sharded BC7 decode {what} differ from one card")
    log(f"four-cards decode_blocks_sharded BPTC {N_DECODE} blocks: "
        f"bit-exact vs one card")

    cfg = _f32(ControllerConfig(n_ilqr_iterations=2, rollout_axis="dp"))
    params, obs, goal = _controller_inputs(cfg, seed)
    with jax.default_matmul_precision("highest"):
        a1, d1 = _one_step(dataclasses.replace(cfg, rollout_axis=None),
                           params, obs, goal, seed, device=devs[0])
        a4, d4 = _one_step(cfg, *jax.device_put((params, obs, goal), rep),
                           seed, mesh=mesh)
    da = float(np.max(np.abs(a4 - a1)))
    dc = max(_rel(d4[k], d1[k]) for k in ("min_cost", "mean_cost"))
    log(f"four-cards control step dp=4, 8192x32, iLQR 2, f32 'highest': "
        f"max |d action| {da:.3g} (tol {ACTION_ATOL_F32}), cost rel "
        f"{dc:.3g} (tol {COST_RTOL_F32}) vs one card")
    check(da <= ACTION_ATOL_F32, f"sharded control action {da}")
    check(dc <= COST_RTOL_F32, f"sharded control costs {dc}")

    dcfg32 = dataclasses.replace(D.DynamicsConfig(),
                                 compute_dtype=jnp.float32)
    env = _train_env(dcfg32, seed)
    tcfg = TrainConfig(dynamics=dcfg32, batch_size=TRAIN_BATCH, n_steps=1,
                       seed=seed, compressed_obs=True, mesh_shape=(4, 1))
    with jax.default_matmul_precision("highest"):
        l4 = _train_losses(tcfg, env)[0]
        l1 = first_step_loss(dcfg32, env, seed, TRAIN_BATCH, tcfg.lr,
                             devs[0])
    r = _rel(l4, l1)
    log(f"four-cards train step dp=4 f32 'highest': loss {l4:.6g} vs one "
        f"card {l1:.6g}, rel {r:.3g} (tol {LOSS_RTOL_F32})")
    check(r <= LOSS_RTOL_F32, f"dp=4 train loss vs one card {r}")


PHASES = {"decode": phase_decode, "texture": phase_texture,
          "control": phase_control, "train": phase_train,
          "four_cards": phase_four_cards}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on 4 GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    try:
        dev = require_gpu(jax.devices())
    except (SmokeFailure, RuntimeError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    from detex_tpu.utils.compile_cache import use_compile_cache
    log(f"compile cache: {use_compile_cache()}")
    log(f"device: {dev.platform} {dev.device_kind}, "
        f"count {len(jax.devices())}")
    from detex_tpu.utils.metrics import nvidia_smi
    log(f"nvidia-smi: {nvidia_smi()}")
    from detex_tpu import engine
    from detex_tpu.utils.blocks import FAMILIES, texture_format
    for fam in FAMILIES:
        log(f"decoder table {fam}: {engine.decoder_name(texture_format(fam))}")
    for name in phases(args.four_cards):
        t0 = time.perf_counter()
        PHASES[name](args.seed)
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
