"""The LM train step (the port's ``repro.train.steps``).

``build_train_step`` returns ``(step, specs, opt)``: ``step(params,
opt_state, batch) → (params, opt_state, metrics)`` runs ``loss_fn``, its
backward pass, global-norm clipping and AdamW; ``specs`` gives the
batch's shapes and dtypes as ``meta`` tensors (the reference's
``ShapeDtypeStruct``s, without shardings): tokens and labels, plus the
vlm's ``img_embed`` and the enc-dec's ``frames`` in the compute dtype.
The loss is ``encdec.loss_fn`` for an enc-dec config and ``lm.loss_fn``
for every other (``model_of``, ``_loss_for``). The reference's
``param_structs`` / ``opt_structs`` carry ``NamedSharding``s and come with
the sharding slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import LMConfig, ShapeConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.nn.layers import cdt
from repro_torch.optim import adamw, clip_by_global_norm_
from repro_torch.optim.optimizers import apply_updates
from repro_torch.utils import tree_map, tree_paths, unflatten_dict

PyTree = Any


def model_of(cfg: LMConfig):
    """The model module of ``cfg``: ``models/encdec`` for an enc-dec
    config, ``models/lm`` for every other."""
    return encdec if cfg.is_encdec else lm


def check_trainable(cfg: LMConfig) -> None:
    """Raise ``NotImplementedError`` for a config neither model module
    trains (a family ``models/lm`` does not know)."""
    if model_of(cfg) is lm:
        lm.check_servable(cfg)


def _loss_for(cfg: LMConfig):
    return model_of(cfg).loss_fn


def make_batch_specs(cfg: LMConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors of one global training batch's shapes and dtypes:
    ``tokens`` and ``labels`` [B, S] int64, the vlm's ``img_embed`` [B,
    n_image_tokens, vision_dim] and the enc-dec's ``frames`` [B, S,
    d_model] in the compute dtype."""
    check_trainable(cfg)
    B, S = shape.global_batch, shape.seq_len
    out = {k: torch.empty((B, S), dtype=torch.int64, device="meta")
           for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        out["img_embed"] = torch.empty(
            (B, cfg.n_image_tokens, cfg.vision_dim), dtype=cdt(cfg),
            device="meta")
    if cfg.is_encdec:
        out["frames"] = torch.empty((B, S, cfg.d_model), dtype=cdt(cfg),
                                    device="meta")
    return out


def build_train_step(cfg: LMConfig, shape: ShapeConfig, lr: float = 3e-4,
                     grad_clip: float = 1.0, donate: bool = True,
                     grad_accum: int = 1,
                     device: str | torch.device | None = None):
    """Returns (step, batch specs, opt).

    ``grad_accum > 1`` splits the global batch into that many microbatches
    run one after another; the gradient is the mean of theirs and the loss
    the mean of their losses, as in the reference. ``donate=True`` writes
    the new params and optimizer state into the tensors it is given
    (``opt.update_``; the reference donates their buffers) and returns
    them; the values are the same bits as with ``donate=False``, which
    returns new trees and leaves the inputs as they were. The gradients are
    the step's own tensors, clipped in place either way. ``device``
    (default ``cuda``) is checked here: params and batch must lie on it.
    """
    dev = resolve_device(device)
    opt = adamw(lr)
    B = shape.global_batch
    if grad_accum < 1 or B % grad_accum:
        raise ValueError(f"grad_accum {grad_accum} does not divide the "
                         f"global batch {B}")
    specs = make_batch_specs(cfg, shape)
    loss_fn = _loss_for(cfg)

    def grads_of(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        paths, leaves = zip(*tree_paths(live))
        loss, metrics = loss_fn(live, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten_dict(dict(zip(paths, grads))))

    def step(params, opt_state, batch):
        for name, spec in specs.items():
            t = batch[name]
            if t.shape != spec.shape or t.device.type != dev.type:
                raise ValueError(f"batch[{name!r}] is {tuple(t.shape)} on "
                                 f"{t.device}; the step takes "
                                 f"{tuple(spec.shape)} on {dev}")
        if grad_accum > 1:
            mb = B // grad_accum
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, _, g = grads_of(params, micro)
                g_sum = tree_map(torch.add, g_sum, g)
                loss_sum = loss_sum + loss
            n = torch.full((), grad_accum, dtype=torch.float32, device=dev)
            grads = tree_map(lambda g: g / n, g_sum)
            loss, metrics = loss_sum / n, {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        with torch.no_grad():
            gnorm = clip_by_global_norm_(grads, grad_clip)
            if donate:
                opt.update_(grads, opt_state, params)
            else:
                updates, opt_state = opt.update(grads, opt_state, params)
                params = apply_updates(params, updates)
        return params, opt_state, dict(metrics, loss=loss, gnorm=gnorm)

    return step, specs, opt

