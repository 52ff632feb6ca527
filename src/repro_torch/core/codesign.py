"""The paper's full model: P²M layer 1 + spiking-CNN backbone — the model
config, initialisation, forward and eval step of ``repro.core.codesign``
in PyTorch. The train step comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import p2m_layer, snn
from repro_torch.core.p2m_layer import P2MConfig
from repro_torch.core.snn import SpikingCNNConfig
from repro_torch.kernels.backend import resolve_device

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
                cfg: P2MModelConfig, *, train: bool = False
                ) -> tuple[torch.Tensor, dict, dict]:
    """Evaluation forward. events [B, T_fine, n_sub, H, W, 2] at the P²M
    fine grid → (logits [B, n_classes], the unchanged BN state, aux) with
    the reference's layer-1 counters ``spikes/p2m``, ``events/in`` and
    ``macs/p2m``. Layer 1 runs in ``cfg.p2m.mode``."""
    if train:
        raise NotImplementedError(
            "model_apply(train=True) comes with the training slice (BN "
            "batch statistics, make_train_step); this port evaluates only")
    spikes1, _ = p2m_layer.p2m_apply(params["p2m"], events, cfg.p2m)
    # layer 1's own 2x pool (pixel-pitch parity with the backbone)
    B, T = spikes1.shape[:2]
    tb = snn.max_pool(spikes1.reshape((B * T,) + spikes1.shape[2:]))
    spikes1 = tb.reshape((B, T) + tb.shape[1:])
    coarse = p2m_layer.coarsen_spikes(spikes1, cfg.coarsen_group())
    logits = snn.spiking_cnn_apply(params["backbone"], state, coarse,
                                   cfg.backbone)
    k = cfg.p2m.kernel_size
    aux = {"spikes/p2m": torch.sum(spikes1),
           "events/in": torch.sum(events),
           "macs/p2m": torch.tensor(float(spikes1.numel()) * k * k
                                    * cfg.p2m.in_channels,
                                    device=events.device)}
    return logits, state, aux


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
            logits, _, aux = model_apply(params, state, events, cfg)
            return {"acc": snn.accuracy(logits, labels),
                    "loss": snn.cross_entropy(logits, labels),
                    "logits": logits}, aux

    return ev_fn
