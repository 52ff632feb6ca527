"""The paper's full model: P²M layer 1 + spiking-CNN backbone — the model
config and initialisation of ``repro.core.codesign`` in PyTorch. The train
and eval steps come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import p2m_layer, snn
from repro_torch.core.p2m_layer import P2MConfig
from repro_torch.core.snn import SpikingCNNConfig

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
