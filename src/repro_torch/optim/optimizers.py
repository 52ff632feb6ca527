"""Optimizers written out (``repro.optim.optimizers`` in PyTorch): AdamW,
SGD (+ momentum), global-norm clipping, LR schedules. Functional over
dict trees of tensors, as the reference is over pytrees:

    opt = adamw(lr=3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``opt.update_(grads, state, params)`` (AdamW) does both in place, leaf by
leaf, with the same operations, so its results are the same bits: the
LM train step's ``donate=True``, which keeps one copy of the params and
moments alive instead of two.

``torch.optim`` is not used: its AdamW folds the weight decay into the
parameter before the step (``p ← p·(1 − lr·wd)``) where the reference
adds ``wd·p`` to the update, and it keeps its state inside the
optimizer object rather than in a tree that checkpoints beside the
params. Moments are float32 and ``step`` an int32 0-dim tensor on the
params' device, as in the reference. On DTensors (a sharded step) the
moments may be placed apart from their params (ZeRO-1): each leaf's
update is computed in its moments' placement and redistributed to its
param's (``_like``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.utils import (tree_leaves, tree_map, tree_map_with_path,
                               tree_paths)

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    update_: Callable[[PyTree, PyTree, PyTree], None] | None = None


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1
                    ) -> Schedule:
    def fn(step):
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        warm = lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return fn


def _clip_scale(grads: PyTree, max_norm: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0), gnorm


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> tuple[PyTree, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / (‖g‖ + 1e-9))``; returns the
    scaled tree and the global norm ‖g‖ (float32, leaves summed in the
    reference's leaf order)."""
    scale, gnorm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm


def clip_by_global_norm_(grads: PyTree, max_norm: float) -> torch.Tensor:
    """:func:`clip_by_global_norm` in place (the same bits); returns ‖g‖."""
    scale, gnorm = _clip_scale(grads, max_norm)
    for g in tree_leaves(grads):
        g.copy_((g * scale).to(g.dtype))
    return gnorm


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params: PyTree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(lr: float | Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01,
          mask_fn: Callable[[str], bool] | None = None) -> Optimizer:
    """AdamW. ``mask_fn(path)`` returns False to disable weight decay on a
    leaf (biases, norms); the update is ``-(lr·(u + wd·p))`` with the
    bias-corrected ``u = m̂ / (√v̂ + eps)``."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = tree_map(_zeros_f32, params)
        return {"mu": zeros, "nu": tree_map(torch.zeros_like, zeros),
                "step": _step0(params)}

    def scalars(state):
        step = state["step"] + 1
        return (step, sched(step), 1 - b1 ** step.to(torch.float32),
                1 - b2 ** step.to(torch.float32))

    def new_mu(m, g):
        return b1 * m + (1 - b1) * g.float()

    def new_nu(v, g):
        return b2 * v + (1 - b2) * torch.square(g.float())

    def delta(path, m, v, p, lr_t, bc1, bc2):
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        wd = weight_decay if (mask_fn is None or mask_fn(path)) else 0.0
        return (-(lr_t * (u + wd * p.float()))).to(p.dtype)

    def update(grads, state, params):
        step, lr_t, bc1, bc2 = scalars(state)
        mu = tree_map(lambda m, g: new_mu(m, _like(g, m)), state["mu"], grads)
        nu = tree_map(lambda v, g: new_nu(v, _like(g, v)), state["nu"], grads)

        def upd(path, p):
            m = _get(mu, path)
            return _like(delta(path, m, _get(nu, path), _like(p, m), lr_t,
                               bc1, bc2), p)
        return (tree_map_with_path(upd, params),
                {"mu": mu, "nu": nu, "step": step})

    def update_(grads, state, params):
        step, lr_t, bc1, bc2 = scalars(state)
        for path, p in tree_paths(params):
            m, v = _get(state["mu"], path), _get(state["nu"], path)
            g = _like(_get(grads, path), m)
            m.copy_(new_mu(m, g))
            v.copy_(new_nu(v, g))
            p.copy_(p + _like(delta(path, m, v, _like(p, m), lr_t, bc1, bc2),
                              p))
        state["step"].copy_(step)

    return Optimizer(init=init, update=update, update_=update_)


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` in ``ref``'s placements when both are DTensors placed apart
    (ZeRO-1 moments shard where their params replicate); else ``t``.
    An in-place DTensor op does not redistribute ``self``, so each update
    is computed in the moments' placement and moved explicitly."""
    placements = getattr(ref, "placements", None)
    if placements is None or t.placements == placements:
        return t
    return t.redistribute(ref.device_mesh, placements)


def _get(tree: PyTree, path: str):
    cur = tree
    for part in path.split("/"):
        cur = cur[part] if isinstance(cur, dict) else cur[int(part)]
    return cur


def sgd(lr: float | Schedule = 1e-2, momentum: float = 0.9,
        nesterov: bool = False) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return {"mom": tree_map(_zeros_f32, params), "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        mom = tree_map(lambda m, g: momentum * m + g.float(), state["mom"],
                       grads)
        eff = (tree_map(lambda m, g: momentum * m + g.float(), mom, grads)
               if nesterov else mom)
        updates = tree_map(lambda e, p: (-(lr_t * e)).to(p.dtype), eff, params)
        return updates, {"mom": mom, "step": step}

    return Optimizer(init=init, update=update)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u, params, updates)
