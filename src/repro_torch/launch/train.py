"""LM training launcher for the PyTorch port (``repro.launch.train`` in
PyTorch).

    python -m repro_torch.launch.train --arch mamba2-780m --smoke --steps 50
    python -m repro_torch.launch.train --device cpu --smoke --steps 4 \\
        --batch 2 --seq 128 --ckpt-dir /tmp/ckpt

``--smoke`` swaps in the reduced same-family config and a ``--batch`` ×
``--seq`` shape, so the whole loop (data → step → checkpoint → restart)
runs end to end; a rerun with the same ``--ckpt-dir`` resumes from its
newest checkpoint (by default the run's last step is one). Without
``--smoke`` the shape is ``--shape`` from ``SHAPES``. The vlm's batch
carries image embeddings [B, n_image_tokens, vision_dim] and the
enc-dec's frame embeddings [B, seq, d_model], the stub front ends'
output: drawn once, each from its own fixed seed (0 and 1) in the compute
dtype, and the same every step, as the reference's.

The loop runs on a mesh (``launch/mesh.py``), as the reference's does:
``make_host_mesh()`` over the job's ranks by default (one rank: ``(1,
1)``), the 16 × 16 production mesh with ``--production-mesh`` and 2 × 16
× 16 with ``--multi-pod``. A job of another size than those need, and an
unknown arch, print ``error: ...`` and exit 2. A job of several ranks is
started by ``torchrun``; every family trains on a mesh (grok-1-314b and
llama-3.2-vision-90b at full width only across many cards).
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import SHAPES, LMConfig, ShapeConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.steps import check_trainable, make_batch_specs


def extra_batch(cfg: LMConfig, shape: ShapeConfig, device):
    """The batch keys beyond tokens and labels (``make_batch_specs``), or
    None: a function that adds the same standard-normal draws to every
    step's batch, ``img_embed`` from seed 0 and ``frames`` from seed 1,
    drawn once on the CPU and placed on ``device`` in the compute dtype."""
    specs = {k: v for k, v in make_batch_specs(cfg, shape).items()
             if k not in ("tokens", "labels")}
    if not specs:
        return None
    seeds = {"img_embed": 0, "frames": 1}
    dev = resolve_device(device)
    extra = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(
        seeds[k])).to(dev, v.dtype) for k, v in specs.items()}
    return lambda batch: dict(batch, **extra)


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

    try:
        cfg = get_config(args.arch)
        check_trainable(cfg)
        if args.production_mesh or args.multi_pod:
            mesh = make_production_mesh(multi_pod=args.multi_pod,
                                        device=args.device)
        else:
            mesh = make_host_mesh(device=args.device)
    except (NotImplementedError, KeyError, ValueError) as e:
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
    res = run(cfg, shape, loop, mesh, device=args.device,
              extra_batch_fn=extra_batch(cfg, shape, args.device))
    if mesh.get_rank() != 0:
        return 0
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
