"""Race each GPU kernel of the engine decoder table against its jnp
fallback, on the card.

For every family whose table entry has a Triton kernel: check the
kernel bit for bit against the jnp decoder, then time both in turns
(a) standalone on 2^n random blocks and (b) inside the fused linear
texture pipeline on a square texture, each sample `--k` back-to-back
calls ending in block_until_ready.  For BC7 also (c) the control step
at its default shape.  Prints one JSON line per family and writes the
report to --out.  A kernel belongs in the table only while it wins (b).

    python tools/kernel_race.py [--families BPTC ETC2] [--out FILE]
    JAX_PLATFORMS=cpu python tools/kernel_race.py --interpret \
        --n-log2 10 --tex 64 --no-control          # CPU rehearsal
"""

import argparse
import functools
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from detex_tpu import engine  # noqa: E402
from detex_tpu import formats as F  # noqa: E402
from detex_tpu.texture import Texture  # noqa: E402
from detex_tpu.utils.blocks import (FAMILIES, random_blocks,  # noqa: E402
                                    texture_format)
from detex_tpu.utils.compile_cache import use_compile_cache  # noqa: E402
from detex_tpu.utils.metrics import (device_info, nvidia_smi,  # noqa: E402
                                     time_samples)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet

def kernel_families():
    """Families whose table entry carries a GPU kernel."""
    return [f for f in FAMILIES
            if hasattr(engine.device_decoder(texture_format(f)),
                       "gpu_kernel")]


def _race(fns, args, reps, rounds, k):
    """Time each fn in turns (a, b, c, c, b, a, ...); (median, min, max)
    seconds per call for each."""
    out = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            out[name] += time_samples(lambda: fns[name](*args), reps, k)
    return {name: (float(np.median(v)), float(min(v)), float(max(v)))
            for name, v in out.items()}


def _compile(fn, *args):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def candidates(name, interpret):
    """The family's jnp fallback and its kernel, both (N, k) rows
    decoders as the table holds them."""
    entry = engine.device_decoder(texture_format(name))
    return {"jnp": entry.fallback,
            "triton": functools.partial(entry.gpu_kernel,
                                        interpret=interpret)}


def race_family(name, args, rng):
    fmt = texture_format(name)
    idx = F.compressed_index(fmt)
    kind = engine._DECODERS[idx][1]
    cands = candidates(name, args.interpret)
    n = 1 << args.n_log2
    blocks = random_blocks(rng, name, n)
    bb = blocks.shape[1]
    rows = jax.device_put(np.ascontiguousarray(blocks).view(np.uint32)
                          .view(np.int32))
    mm, fl = np.uint32(0xFFFFFFFF), np.uint32(0)
    res = {"n_blocks": n, "block_bytes": bb}
    fns = {key: jax.jit(dec) for key, dec in cands.items()}
    for key, fn in fns.items():
        res[f"{key}_compile_s"] = _compile(fn, rows, mm, fl)
    (pix_j, val_j), (pix_k, val_k) = (fns[k](rows, mm, fl) for k in fns)
    res["bit_exact"] = bool(jnp.array_equal(pix_k, pix_j)) and \
        bool(jnp.array_equal(val_k, val_j))
    out_bytes = int(pix_j.shape[1]) * 4
    res["out_bytes"] = out_bytes
    times = _race(fns, (rows, mm, fl), args.reps, args.rounds, args.k)
    for key, (med, lo, hi) in times.items():
        res[f"{key}_ns_per_block"] = med / n * 1e9
        res[f"{key}_spread_pct"] = 100 * (hi - lo) / med
        res[f"{key}_hbm_share"] = n * (bb + out_bytes) / med \
            / HBM_BYTES_PER_S

    # Fused linear pipeline on a tex x tex texture, default pixel format,
    # with each decoder in the engine's table.
    side = args.tex
    tb = random_blocks(rng, name, (side // 4) ** 2)
    tex = Texture.new(fmt, tb.reshape(-1), side, side)
    pf = F.texture_pixel_format(fmt)
    words = engine._device_words(tex, pf)
    saved = engine._DECODERS[idx]
    pfns = {}
    for key, dec in cands.items():
        engine._DECODERS[idx] = (dec, kind)
        engine._device_pipeline.cache_clear()
        try:
            pfns[key] = engine._device_pipeline(fmt, pf, side // 4,
                                                side // 4, side, side, ())
        finally:
            engine._DECODERS[idx] = saved
            engine._device_pipeline.cache_clear()
        res[f"pipe_{key}_compile_s"] = _compile(pfns[key], words, mm, fl)
    res["pipe_bit_exact"] = bool(jnp.array_equal(
        *(fn(words, mm, fl) for fn in pfns.values())))
    ptimes = _race(pfns, (words, mm, fl), args.reps, args.rounds, args.k)
    nt = (side // 4) ** 2
    for key, (med, lo, hi) in ptimes.items():
        res[f"pipe_{key}_ms"] = med * 1e3
        res[f"pipe_{key}_spread_pct"] = 100 * (hi - lo) / med
        res[f"pipe_{key}_ns_per_block"] = med / nt * 1e9
    return res


def race_control_step(args):
    """Default-shape control step with the BC7 jnp fallback vs the BC7
    kernel; Controller.step blocks for every action."""
    from detex_tpu.mpc import dynamics as D
    from detex_tpu.mpc.runtime import Controller, ControllerConfig
    cfg = ControllerConfig()
    params = D.init_params(jax.random.PRNGKey(0), cfg.dynamics)
    goal = jnp.zeros((cfg.dynamics.latent_dim,), jnp.float32)
    rng = np.random.default_rng(1)
    nb = (cfg.dynamics.image_size // 4) ** 2
    obs = jnp.asarray(random_blocks(rng, "BPTC", nb).view(np.uint32)
                      .view(np.int32))
    out = {}
    saved = engine._DECODERS[F.IDX_BPTC]
    ctrls = {}
    for key, dec in candidates("BPTC", args.interpret).items():
        engine._DECODERS[F.IDX_BPTC] = (dec, "u32")
        try:
            c = Controller(params, goal, cfg, seed=0)
            out[f"{key}_compile_s"] = _compile(c.step, obs)
            ctrls[key] = c
        finally:
            engine._DECODERS[F.IDX_BPTC] = saved
    ts = {k: [] for k in ctrls}
    order = list(ctrls)
    for r in range(args.rounds * 4):
        for k in (order if r % 2 == 0 else order[::-1]):
            for _ in range(5):
                t0 = time.perf_counter()
                ctrls[k].step(obs)
                ts[k].append(time.perf_counter() - t0)
    for k, v in ts.items():
        out[f"{k}_step_ms"] = float(np.median(v)) * 1e3
        out[f"{k}_p10_p90_spread_pct"] = float(
            100 * (np.percentile(v, 90) - np.percentile(v, 10))
            / np.median(v))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-log2", type=int, default=22)
    ap.add_argument("--tex", type=int, default=4096)
    ap.add_argument("--families", nargs="+", default=kernel_families())
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--k", type=int, default=20,
                    help="calls enqueued per timed sample")
    ap.add_argument("--interpret", action="store_true")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=REPO / "out" / "kernel_race.json")
    args = ap.parse_args()
    use_compile_cache()
    device = device_info()
    if device["platform"] != "gpu" and not args.interpret:
        sys.exit("kernel_race: no GPU (pass --interpret for a CPU run)")
    smi = nvidia_smi() if device["platform"] == "gpu" else "no GPU"
    print(f"device {device} | {smi}", flush=True)
    report = {"device": device, "nvidia_smi": smi, "families": {}}
    rng = np.random.default_rng(0)
    for name in args.families:
        report["families"][name] = r = race_family(name, args, rng)
        print(name, json.dumps(r), flush=True)
    if not args.no_control and "BPTC" in args.families:
        report["control_step"] = r = race_control_step(args)
        print("control_step", json.dumps(r), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
