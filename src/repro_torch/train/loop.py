"""The training loop (the port's ``repro.train.loop``): data cursor,
checkpoint/restart, straggler monitoring, preemption handling, metrics.

Composes the pieces that are tested one by one:

  train/steps.build_train_step   the step (params/opt updated in place)
  data/tokens.TokenLoader        step-keyed batches → exact restart replay
  checkpoint.CheckpointManager   async atomic checkpoints + retention
  ft.StragglerMonitor            per-step EMA/kσ outlier flags
  ft.PreemptionGuard             SIGTERM → drain + final checkpoint

One step per iteration, everything else (I/O, monitors) off the device's
path. ``device`` (default ``cuda``) is where the loop runs; with a
``mesh`` (``launch/mesh.py``; the reference's ``with mesh:``) the step is
``build_train_step``'s sharded one and params, optimizer state and every
batch are DTensors placed by its structs. A checkpoint stays
framework-neutral either way: each leaf is gathered whole
(``full_tensor()``) and rank 0 writes ``host_*.npz`` + ``index.json``;
a restore reads the arrays and places them by their specs, as the
reference restores with ``shardings=``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import LMConfig, ShapeConfig
from repro_torch.data.tokens import TokenLoader, TokenStreamConfig
from repro_torch.ft import PreemptionGuard, StragglerMonitor
from repro_torch.kernels.backend import resolve_device
from repro_torch.sharding import rules
from repro_torch.train.steps import build_train_step, model_of

PyTree = Any


@dataclass
class LoopConfig:
    total_steps: int = 200
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "artifacts/ckpt"
    ckpt_keep: int = 2
    ckpt_async: bool = True
    lr: float = 3e-4
    seed: int = 0
    straggler_k_sigma: float = 4.0
    on_straggler: str = "log"       # log | checkpoint


@dataclass
class LoopResult:
    final_step: int
    losses: list = field(default_factory=list)
    straggler_flags: int = 0
    preempted: bool = False
    restored_from: int | None = None
    # per step run here, beside ``losses``: the gradient norm, the host
    # seconds from drawing the batch to the loss on the host, and the
    # loss's parts as floats ({"ce", "lb"}; empty under grad_accum > 1)
    gnorms: list = field(default_factory=list)
    step_s: list = field(default_factory=list)
    parts: list = field(default_factory=list)


def init_train_state(cfg: LMConfig, opt, device: torch.device,
                     structs: tuple | None = None) -> tuple[PyTree, PyTree]:
    """Params drawn from seed 0 on ``device`` (a CUDA generator draws on
    the card; ``encdec.init_params`` for an enc-dec config) and their
    optimizer state. With ``structs`` (the sharded step's (params, opt)
    structs) the params are placed by their specs and the optimizer state
    is made in its own placements, each rank allocating its shards."""
    params = model_of(cfg).init_params(
        torch.Generator(device=device).manual_seed(0), cfg, device)
    if structs is None:
        return params, opt.init(params)
    p_sds, o_sds = structs
    return rules.place_as(params, p_sds), rules.zeros(o_sds)


def run(cfg: LMConfig, shape: ShapeConfig, loop: LoopConfig, mesh=None,
        log: Callable[[str], None] = print,
        extra_batch_fn: Callable[[dict], dict] | None = None,
        device: str | torch.device | None = None) -> LoopResult:
    """Train ``cfg`` on the synthetic token stream. Restartable: if a
    committed checkpoint exists under ``loop.ckpt_dir`` it resumes from it
    (params, opt state, data cursor). Every rank of a mesh runs this with
    the same arguments; rank 0 logs and writes the checkpoints."""
    dev = resolve_device(device)
    result = LoopResult(final_step=0)
    if mesh is None:
        step_fn, _, opt = build_train_step(cfg, shape, lr=loop.lr,
                                           device=dev)
        params, opt_state = init_train_state(cfg, opt, dev)
    else:
        step_fn, (p_sds, o_sds, b_sds), opt = build_train_step(
            cfg, shape, mesh, lr=loop.lr)
        params, opt_state = init_train_state(cfg, opt, dev, (p_sds, o_sds))
        lead = mesh.get_rank() == 0
        if not lead:
            log = lambda _: None          # noqa: E731
    loader = TokenLoader(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=loop.seed))

    ckpt = CheckpointManager(loop.ckpt_dir, every_steps=loop.ckpt_every,
                             keep=loop.ckpt_keep)
    restored = ckpt.restore(device=dev)
    start_step = 0
    if restored is not None:
        tree, extra = restored
        if mesh is not None:
            tree = rules.place_as(tree, {"params": p_sds, "opt": o_sds})
        params, opt_state = tree["params"], tree["opt"]
        start_step = int(extra.get("step", 0))
        loader.seek(start_step)
        result.restored_from = start_step
        log(f"[loop] restored from step {start_step}")

    def save(step, blocking):
        tree = {"params": params, "opt": opt_state}
        if mesh is not None:
            tree = rules.gather(tree)     # every rank takes part
            if not lead:
                return
        ckpt.save(step, tree, extra={"step": step}, blocking=blocking)

    monitor = StragglerMonitor(k_sigma=loop.straggler_k_sigma)
    with PreemptionGuard() as guard:
        for step in range(start_step, loop.total_steps):
            t0 = time.perf_counter()
            _, batch = next(loader)
            if extra_batch_fn is not None:
                batch = extra_batch_fn(batch)
            batch = {k: v.to(dev) for k, v in batch.items()}
            if mesh is not None:
                batch = rules.place_as(batch, b_sds)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            gnorm = float(metrics["gnorm"])

            if monitor.observe(step, dt):
                result.straggler_flags += 1
                log(f"[loop] step {step}: straggler flagged "
                    f"({dt:.3f}s vs mean {monitor.mean_s:.3f}s)")
                if loop.on_straggler == "checkpoint":
                    save(step + 1, not loop.ckpt_async)

            if step % loop.log_every == 0:
                log(f"[loop] step {step} loss={loss:.4f} gnorm={gnorm:.3f} "
                    f"dt={dt:.3f}s")
            result.losses.append(loss)
            result.gnorms.append(gnorm)
            result.step_s.append(dt)
            result.parts.append({k: float(metrics[k]) for k in ("ce", "lb")
                                 if k in metrics})

            if ckpt.should_save(step + 1):
                save(step + 1, not loop.ckpt_async)

            if guard.preempted:
                log(f"[loop] preempted at step {step}; draining")
                save(step + 1, True)
                result.preempted = True
                result.final_step = step + 1
                return result

            result.final_step = step + 1

    ckpt.wait()
    return result
