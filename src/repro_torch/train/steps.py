"""The LM train step (the port's ``repro.train.steps``).

``build_train_step(cfg, shape)`` returns ``(step, specs, opt)``:
``step(params, opt_state, batch) → (params, opt_state, metrics)`` runs
``loss_fn``, its backward pass, global-norm clipping and AdamW on one
device; ``specs`` gives the batch's shapes and dtypes as ``meta`` tensors:
tokens and labels, plus the vlm's ``img_embed`` and the enc-dec's
``frames`` in the compute dtype. The loss is ``encdec.loss_fn`` for an
enc-dec config and ``lm.loss_fn`` for every other (``model_of``,
``_loss_for``).

With a mesh (``build_train_step(cfg, shape, mesh)``, a ``DeviceMesh``
from ``launch/mesh.py``) it returns the reference's ``(step, (params,
opt, batch structs), opt)``: :func:`param_structs`, :func:`opt_structs`
and :func:`make_batch_specs` give ``sharding/rules.Struct`` trees (a
``meta`` tensor and its spec a leaf; the reference's ``jax.eval_shape``
with ``NamedSharding``s), and the step takes params, optimizer state and
batch as DTensors placed by them (``rules.place``). The body runs under
DTensor's op-by-op sharding propagation with the reference's pins
(``rules.shard_batch``); the gradients, partial sums over the batch
shards, are reduced to their params' placements before clipping, and
AdamW computes each update in its moments' (ZeRO-1) placement.
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
from repro_torch.sharding import rules
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


def make_batch_specs(cfg: LMConfig, shape: ShapeConfig, mesh=None) -> dict:
    """``meta`` tensors of one global training batch's shapes and dtypes:
    ``tokens`` and ``labels`` [B, S] int64, the vlm's ``img_embed`` [B,
    n_image_tokens, vision_dim] and the enc-dec's ``frames`` [B, S,
    d_model] in the compute dtype. With a mesh, ``rules.Struct``s that
    carry ``rules.input_pspecs``' specs."""
    if mesh is not None:
        return rules.structs(make_batch_specs(cfg, shape),
                             rules.input_pspecs(cfg, shape, mesh), mesh)
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


def param_structs(cfg: LMConfig, mesh) -> tuple[PyTree, PyTree]:
    """(``rules.Struct`` tree, spec tree) of ``cfg``'s params on ``mesh``;
    nothing is allocated."""
    shapes = model_of(cfg)._init(None, cfg)
    specs = rules.param_pspecs(shapes, cfg, mesh)
    return rules.structs(shapes, specs, mesh), specs


def opt_structs(opt, param_structs_tree: PyTree, param_pspecs: PyTree,
                cfg: LMConfig, mesh) -> tuple[PyTree, PyTree]:
    """(``rules.Struct`` tree, spec tree) of ``opt``'s state: AdamW's
    ``mu`` and ``nu`` under ``rules.zero1_pspecs``, ``step`` replicated."""
    metas = tree_map(lambda s: s.meta, param_structs_tree)
    shapes = opt.init(metas)
    moment_specs = rules.zero1_pspecs(param_pspecs, metas, mesh, cfg)
    specs = {"mu": moment_specs, "nu": moment_specs, "step": ()}
    return rules.structs(shapes, specs, mesh), specs


def build_train_step(cfg: LMConfig, shape: ShapeConfig, mesh=None,
                     lr: float = 3e-4, grad_clip: float = 1.0,
                     donate: bool = True, grad_accum: int = 1,
                     device: str | torch.device | None = None):
    """Returns (step, batch specs, opt); with a mesh, (step, (params,
    opt, batch structs), opt) and the sharded step (:func:`_sharded_step`).

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
    if mesh is not None:
        return _sharded_step(cfg, shape, mesh, lr, grad_clip, donate,
                             grad_accum)
    dev = resolve_device(device)
    opt = adamw(lr)
    B = shape.global_batch
    if grad_accum < 1 or B % grad_accum:
        raise ValueError(f"grad_accum {grad_accum} does not divide the "
                         f"global batch {B}")
    specs = make_batch_specs(cfg, shape)
    loss_fn = _loss_for(cfg)

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
                loss, _, g = _grads(loss_fn, cfg, params, micro)
                g_sum = tree_map(torch.add, g_sum, g)
                loss_sum = loss_sum + loss
            n = torch.full((), grad_accum, dtype=torch.float32, device=dev)
            grads = tree_map(lambda g: g / n, g_sum)
            loss, metrics = loss_sum / n, {}
        else:
            loss, metrics, grads = _grads(loss_fn, cfg, params, batch)
        with torch.no_grad():
            gnorm = clip_by_global_norm_(grads, grad_clip)
            if donate:
                opt.update_(grads, opt_state, params)
            else:
                updates, opt_state = opt.update(grads, opt_state, params)
                params = apply_updates(params, updates)
        return params, opt_state, dict(metrics, loss=loss, gnorm=gnorm)

    return step, specs, opt



def _grads(loss_fn, cfg: LMConfig, params, batch):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: the gradient
    tree by one ``autograd.grad`` over every leaf."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    paths, leaves = zip(*tree_paths(live))
    loss, metrics = loss_fn(live, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_dict(dict(zip(paths, grads))))


def _replicated(t):
    """A DTensor scalar (a partial sum over the batch shards) reduced and
    returned as the plain tensor every rank holds; a plain tensor as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim).to_local()


def _sharded_step(cfg: LMConfig, shape: ShapeConfig, mesh, lr: float,
                  grad_clip: float, donate: bool, grad_accum: int):
    """``build_train_step`` on ``mesh``. ``step(params, opt_state, batch)``
    takes DTensors placed by the returned structs and returns them so
    placed (written in place with ``donate``); its metrics are plain
    tensors, the same on every rank."""
    if grad_accum != 1:
        raise NotImplementedError(
            "grad_accum > 1 on a mesh is not ported; the one-device step "
            "(mesh=None) takes it")
    opt = adamw(lr)
    loss_fn = _loss_for(cfg)
    p_sds, p_specs = param_structs(cfg, mesh)
    o_sds, _ = opt_structs(opt, p_sds, p_specs, cfg, mesh)
    b_sds = make_batch_specs(cfg, shape, mesh)

    def step(params, opt_state, batch):
        for name, sds in b_sds.items():
            rules.check_placed(f"batch[{name!r}]", batch[name], sds)
        with rules.use_mesh(mesh):
            loss, metrics, grads = _grads(loss_fn, cfg, params, batch)
            # the gradients of params the batch shards do not split are
            # partial sums: reduce each to its param's placements
            grads = tree_map(lambda g, p: g.redistribute(mesh, p.placements),
                             grads, params)
            with torch.no_grad():
                gnorm = clip_by_global_norm_(grads, grad_clip)
                if donate:
                    opt.update_(grads, opt_state, params)
                else:
                    updates, opt_state = opt.update(grads, opt_state, params)
                    params = apply_updates(params, updates)
            metrics = {k: _replicated(v) for k, v in
                       dict(metrics, loss=loss, gnorm=gnorm).items()}
        return params, opt_state, metrics

    return step, (p_sds, o_sds, b_sds), opt
