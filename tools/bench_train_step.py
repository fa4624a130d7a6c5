"""Compressed-observation TRAINING step timing on the GPU at the
north-star shapes (train and control share the BC7 perception path).

Shapes: batch of 64x64 BC7-compressed observations (256 blocks each),
the default DynamicsConfig (latent 128, hidden 512, bf16 compute; f32
on a CPU).  Three rows, each the median ms per call over `--samples`
samples of `--k` back-to-back calls ending in block_until_ready:

  * compressed-obs step (BC7 decode of obs + next_obs in-graph)
  * raw-obs step (same model, pre-decoded uint8 observations)
  * decode-only (the two decode_obs_batch calls)

Usage: python tools/bench_train_step.py [--batch 256]
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax                      # noqa: E402
import jax.numpy as jnp         # noqa: E402
import numpy as np              # noqa: E402

from detex_tpu.mpc import dynamics as D                    # noqa: E402
from detex_tpu.mpc.runtime import decode_obs_batch         # noqa: E402
from detex_tpu.mpc.train_loop import CorpusReplayEnv       # noqa: E402
from detex_tpu.utils.compile_cache import use_compile_cache  # noqa: E402
from detex_tpu.utils.metrics import (device_info, nvidia_smi,  # noqa: E402
                                     time_per_call)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()
    use_compile_cache()
    device = device_info()
    on_cpu = device["platform"] == "cpu"
    dcfg = D.DynamicsConfig()
    if on_cpu:      # bf16 matmuls are emulated, and slow, on a CPU
        dcfg = dataclasses.replace(dcfg, compute_dtype=jnp.float32)
    s = dcfg.image_size
    n_blocks = (s // 4) ** 2

    params = D.init_params(jax.random.PRNGKey(0), dcfg)
    opt = D.make_optimizer()
    opt_state = opt.init(params)
    env = CorpusReplayEnv(dcfg, seed=0, corpus_path=None)
    rng = np.random.default_rng(0)
    batch = jax.device_put(env.sample_batch(rng, args.batch))
    raw = {"obs": jnp.asarray(rng.integers(
               0, 256, (args.batch, s, s, dcfg.channels), np.uint8)),
           "next_obs": jnp.asarray(rng.integers(
               0, 256, (args.batch, s, s, dcfg.channels), np.uint8)),
           "action": batch["action"]}

    def decode(b):
        return (decode_obs_batch(b["obs_words"], s, s),
                decode_obs_batch(b["next_obs_words"], s, s))

    def compressed_step(p, o, b):
        obs, next_obs = decode(b)
        return D.train_step(p, o, {"obs": obs, "next_obs": next_obs,
                                   "action": b["action"]},
                            cfg=dcfg, optimizer=opt)

    # The same steps as train_loop.make_train_step, without donation:
    # the same params feed every timed call.
    compressed = jax.jit(compressed_step)
    plain = jax.jit(lambda p, o, b: D.train_step(p, o, b, cfg=dcfg,
                                                 optimizer=opt))
    decode = jax.jit(decode)
    rows = {
        "compressed": lambda: compressed(params, opt_state, batch),
        "raw_obs": lambda: plain(params, opt_state, raw),
        "decode_only": lambda: decode(batch),
    }
    out = {"metric": "compressed_obs_train_step", "batch": args.batch,
           "obs": f"{s}x{s} BC7 ({n_blocks} blocks), replay pool",
           "model": f"latent-{dcfg.latent_dim}/hidden-{dcfg.hidden_dim} "
                    f"{jnp.dtype(dcfg.compute_dtype).name}",
           "device": device,
           "nvidia_smi": "no GPU" if device["platform"] != "gpu"
           else nvidia_smi()}
    for name, fn in rows.items():
        jax.block_until_ready(fn())                 # compile + warm
        sec, spread = time_per_call(fn, args.samples, args.k)
        out[f"ms_{name}"] = sec * 1e3
        out[f"spread_pct_{name}"] = spread
    out["decode_share_pct"] = 100 * (out["ms_compressed"]
                                     - out["ms_raw_obs"]) \
        / out["ms_compressed"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
