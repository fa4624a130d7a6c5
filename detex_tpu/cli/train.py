"""dtx-train: train the visual-latent dynamics model.

Runs the mesh-sharded training loop (mpc.train_loop) on the synthetic
visual environment, or as a template for a real data source.  Works
unchanged single-host or multi-host (jax.distributed auto-init from
standard env vars).

Example:
  python -m detex_tpu.cli.train --steps 500 --batch-size 128 \
      --checkpoint-dir /tmp/dtx-ckpt --mesh 4x2
"""

from __future__ import annotations

import argparse
import sys

from detex_tpu.mpc import dynamics as D
from detex_tpu.mpc.train_loop import TrainConfig, train
from detex_tpu.parallel import distributed
from detex_tpu.utils.compile_cache import use_compile_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dtx-train")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--latent-dim", type=int, default=64)
    p.add_argument("--action-dim", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--mesh", default=None,
                   help="mesh shape dpxtp, e.g. 4x2 (default: all dp)")
    args = p.parse_args(argv)
    use_compile_cache()

    distributed.initialize()
    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)
    cfg = TrainConfig(
        dynamics=D.DynamicsConfig(image_size=args.image_size,
                                  latent_dim=args.latent_dim,
                                  action_dim=args.action_dim),
        batch_size=args.batch_size, n_steps=args.steps, lr=args.lr,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, mesh_shape=mesh_shape)
    _, _, loss = train(cfg)
    print(f"final loss: {loss:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
