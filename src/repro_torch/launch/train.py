"""LM training launcher for the PyTorch port (``repro.launch.train`` in
PyTorch).

    python -m repro_torch.launch.train --arch mamba2-780m --smoke --steps 50
    python -m repro_torch.launch.train --device cpu --smoke --steps 4 \\
        --batch 2 --seq 128 --ckpt-dir /tmp/ckpt

``--smoke`` swaps in the reduced same-family config and a ``--batch`` ×
``--seq`` shape, so the whole loop (data → step → checkpoint → restart)
runs end to end; a rerun with the same ``--ckpt-dir`` resumes from its
newest checkpoint (by default the run's last step is one). Without
``--smoke`` the shape is ``--shape`` from ``SHAPES``. The port trains
the ``dense`` (without qk-norm or GeGLU) and ``ssm`` families on one
device; the other architectures (``lm.check_trainable``: the moe and
hybrid families, qk-norm and GeGLU, and ``configs.LATER``),
``--production-mesh`` and ``--multi-pod`` (sharding) print
``error: ...`` and exit 2.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.models import lm
from repro_torch.train.loop import LoopConfig, run


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default="internlm2-1.8b")
    ap.add_argument("--shape", type=str, default="train_4k",
                    choices=sorted(SHAPES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config and a --batch x --seq shape")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default: min(50, "
                         "--steps), so a short run ends on one)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    if args.production_mesh or args.multi_pod:
        print("error: --production-mesh and --multi-pod need the sharded "
              "step builders, which are not ported yet (ROADMAP.md, queue "
              "4); the port trains on one device", file=sys.stderr)
        return 2
    try:
        cfg = get_config(args.arch)
        lm.check_trainable(cfg)
    except (NotImplementedError, KeyError) as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.smoke:
        cfg = smoke_variant(cfg)
        shape = ShapeConfig("smoke", "train", args.seq, args.batch)
    else:
        shape = SHAPES[args.shape]

    loop = LoopConfig(total_steps=args.steps, lr=args.lr,
                      ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every or min(50, args.steps))
    res = run(cfg, shape, loop, device=args.device)
    if not res.losses:
        print(f"[train] nothing to do: restored at step {res.final_step} of "
              f"{args.steps}")
        return 0
    print(f"[train] done at step {res.final_step} "
          f"first_loss={res.losses[0]:.4f} last_loss={res.losses[-1]:.4f} "
          f"stragglers={res.straggler_flags} preempted={res.preempted}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
