"""The paper's full model: P²M layer 1 + spiking-CNN backbone — the model
config, initialisation, forward, train step and eval step of
``repro.core.codesign`` in PyTorch.

Training follows the reference (paper §3): layer 1 trains through the
differentiable curve-fit forward (``cfg.p2m.mode = "curvefit"``, the
default), the backbone's LIF through ``snn.lif_over_time`` and its
surrogate gradient; no hand-written kernel runs in a train step. Under
``freeze_p2m`` layer 1 is held fixed (paper §3, phase 2).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import torch

from repro_torch.core import p2m_layer, snn
from repro_torch.core.leakage import CircuitConfig
from repro_torch.core.p2m_layer import P2MConfig
from repro_torch.core.snn import SpikingCNNConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm)
from repro_torch.utils import tree_map, tree_paths, unflatten_dict

Params = dict


@dataclass(frozen=True)
class P2MModelConfig:
    """Full paper model: P²M first layer + digital spiking backbone."""
    p2m: P2MConfig = field(default_factory=P2MConfig)
    backbone: SpikingCNNConfig = field(default_factory=lambda: SpikingCNNConfig(
        first_layer_external=True))
    coarse_window_ms: float = 1000.0     # backbone integration time

    def coarsen_group(self) -> int:
        """T_INTG windows per coarse backbone frame."""
        g = self.coarse_window_ms / self.p2m.t_intg_ms
        if abs(g - round(g)) > 1e-6:
            raise ValueError(f"T_INTG {self.p2m.t_intg_ms} ms does not divide "
                             f"the coarse window {self.coarse_window_ms} ms")
        return int(round(g))


def model_init(gen: torch.Generator, cfg: P2MModelConfig
               ) -> tuple[Params, dict]:
    """Fresh params ``{"p2m", "backbone"}`` and BN state, drawn on the CPU
    from ``gen`` (so a seed gives the same weights on every device)."""
    p2m_params = p2m_layer.p2m_init(gen, cfg.p2m)
    bb_params, bb_state = snn.spiking_cnn_init(gen, cfg.backbone)
    return {"p2m": p2m_params, "backbone": bb_params}, bb_state


def model_apply(params: Params, state: dict, events: torch.Tensor,
                cfg: P2MModelConfig, *, train: bool
                ) -> tuple[torch.Tensor, dict, dict]:
    """events [B, T_fine, n_sub, H, W, 2] at the P²M fine grid → (logits
    [B, n_classes], new BN state, aux). Layer 1 runs in ``cfg.p2m.mode``;
    with ``train`` the backbone's BN normalises by batch statistics and
    the returned state carries the moved running statistics. ``aux`` holds
    the backbone's ``spikes/*`` and ``synops/*`` counters and layer 1's
    ``spikes/p2m``, ``events/in`` and ``macs/p2m``, as the reference's.

    ``kernel`` mode under autograd raises: the P²M conv kernel has no
    backward (nor has the reference's Pallas kernel); train through
    ``curvefit``."""
    if train and cfg.p2m.mode == "kernel" and torch.is_grad_enabled():
        raise NotImplementedError(
            "layer 1 in kernel mode has no backward (the P²M conv kernel "
            "is forward only); train with p2m.mode='curvefit'")
    spikes1, _ = p2m_layer.p2m_apply(params["p2m"], events, cfg.p2m)
    # layer 1's own 2x pool (pixel-pitch parity with the backbone)
    B, T = spikes1.shape[:2]
    tb = snn.max_pool(spikes1.reshape((B * T,) + spikes1.shape[2:]))
    spikes1 = tb.reshape((B, T) + tb.shape[1:])
    coarse = p2m_layer.coarsen_spikes(spikes1, cfg.coarsen_group())
    logits, new_state, aux = snn.spiking_cnn_apply(
        params["backbone"], state, coarse, cfg.backbone, train=train)
    k = cfg.p2m.kernel_size
    aux["spikes/p2m"] = torch.sum(spikes1).detach()
    aux["events/in"] = torch.sum(events).detach()
    aux["macs/p2m"] = torch.tensor(float(spikes1.numel()) * k * k
                                   * cfg.p2m.in_channels,
                                   device=events.device)
    return logits, new_state, aux


def make_train_step(cfg: P2MModelConfig, opt: Optimizer, *,
                    freeze_p2m: bool,
                    device: str | torch.device | None = None):
    """``step(params, opt_state, state, events, labels) → (params,
    opt_state, new_state, {"loss", "gnorm", "acc"}, aux)`` on ``device``
    (cuda unless the caller asks for the CPU). Params, optimizer state and
    BN state must already be on that device; events and labels are moved
    there. Functional: the inputs are not modified.

    The reference's order of work: the cross-entropy loss and its
    gradients; under ``freeze_p2m`` the layer-1 gradients zeroed before
    the clip (so they add nothing to ``gnorm``); the clip at global norm
    1; the optimizer update; under ``freeze_p2m`` the layer-1 updates
    zeroed too (AdamW's weight decay would otherwise shrink the frozen
    weights); then the update applied. Frozen layer-1 leaves are not
    differentiated at all, so no layer-1 graph is kept; their zero
    gradients are what the reference computes and then discards."""
    dev = resolve_device(device)

    def step(params: Params, opt_state, state: dict, events, labels):
        events = torch.as_tensor(events, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev).long()
        leaves = dict(tree_paths(params))
        trainable = [path for path in leaves
                     if not (freeze_p2m and path.startswith("p2m/"))]
        diff = {path: t.detach().requires_grad_(path in trainable)
                for path, t in leaves.items()}
        with torch.enable_grad():
            logits, new_state, aux = model_apply(
                unflatten_dict(diff), state, events, cfg, train=True)
            loss = snn.cross_entropy(logits, labels)
            got = torch.autograd.grad(loss, [diff[p] for p in trainable])
        by_path = dict(zip(trainable, got))
        grads = unflatten_dict({path: by_path[path] if path in by_path
                                else torch.zeros_like(t)
                                for path, t in leaves.items()})
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        if freeze_p2m:
            updates = {**updates,
                       "p2m": tree_map(torch.zeros_like, updates["p2m"])}
        params = apply_updates(params, updates)
        logits = logits.detach()
        metrics = {"loss": loss.detach(), "gnorm": gnorm,
                   "acc": snn.accuracy(logits, labels)}
        return params, opt_state, new_state, metrics, aux

    return step


def make_eval_fn(cfg: P2MModelConfig, *,
                 device: str | torch.device | None = None):
    """``ev_fn(params, state, events, labels) → ({"acc", "loss",
    "logits"}, aux)`` on ``device``: cuda unless the caller asks for the
    CPU, and raises without a GPU. Params and state must already be on
    that device; events and labels are moved there."""
    dev = resolve_device(device)

    def ev_fn(params: Params, state: dict, events, labels
              ) -> tuple[dict, dict]:
        events = torch.as_tensor(events, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev).long()
        with torch.no_grad():
            logits, _, aux = model_apply(params, state, events, cfg,
                                         train=False)
            return {"acc": snn.accuracy(logits, labels),
                    "loss": snn.cross_entropy(logits, labels),
                    "logits": logits}, aux

    return ev_fn


# ---------------------------------------------------------------------------
# the sweep (Table 1 / Fig 2)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepConfig:
    t_intg_grid_ms: tuple[float, ...] = (1.0, 10.0, 100.0, 1000.0)
    batch_size: int = 8
    pretrain_steps: int = 40
    finetune_steps: int = 15
    eval_batches: int = 4
    lr: float = 2e-3
    # layer-1 LR for the unfrozen joint update (sweep.joint_optimizer);
    # None → ``lr``
    lr_p2m: float | None = None
    seed: int = 0
    # dataset (data.sources.resolve_dataset) used when run_sweep is given
    # no source
    dataset: str = "synthetic-gesture"
    data_root: str | None = None


def run_sweep(data_cfg: Any = None,
              model_cfg: P2MModelConfig | None = None,
              sweep: SweepConfig = SweepConfig(),
              circuit: CircuitConfig = CircuitConfig.NULLIFIED,
              log: Any = print,
              protocol: str = "frozen",
              devices: int | None = None,
              eval_data: Any = None,
              device: str | torch.device | None = None) -> list[dict]:
    """The co-design T_INTG sweep for one circuit config on ``device``
    (cuda unless the caller asks for the CPU): one record per grid point
    with accuracy, train time, bandwidth and backend energies. A
    single-circuit wrapper over ``core.sweep.run_grid``, whose stacked
    config axis here has length 1. ``data_cfg=None`` resolves
    ``sweep.dataset`` at the backbone's input resolution; ``devices``
    shards the stacked config axis (``core/sweep_exec.py``), checked
    against the visible cards before any compute."""
    from repro_torch.core import sweep as sweep_engine
    from repro_torch.core.sweep_exec import make_executor
    from repro_torch.data import sources as sources_mod

    executor = make_executor(devices,
                             device=torch.device(device or "cuda").type)
    if model_cfg is None:
        model_cfg = P2MModelConfig()
    if data_cfg is None:
        data_cfg = sources_mod.resolve_dataset(
            sweep.dataset, hw=model_cfg.backbone.input_hw[0],
            data_root=sweep.data_root)
    mcfg = replace(model_cfg,
                   p2m=replace(model_cfg.p2m,
                               leak=replace(model_cfg.p2m.leak,
                                            circuit=circuit)))
    grid = sweep_engine.SweepGrid(
        circuits=(circuit,),
        t_intg_grid_ms=tuple(sweep.t_intg_grid_ms),
        null_mismatch=(mcfg.p2m.leak.null_mismatch,))
    result = sweep_engine.run_grid(data_cfg, mcfg, sweep, grid, log=log,
                                   protocol=protocol, executor=executor,
                                   eval_data=eval_data, device=device)
    return result.records
