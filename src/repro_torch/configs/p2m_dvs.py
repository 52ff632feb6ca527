"""The paper's own model: P²M-constrained spiking CNN for DVS gesture
recognition (4 conv + FC512 + FC-classes; first layer in-pixel analog).
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.core.codesign import P2MModelConfig
from repro_torch.core.leakage import CircuitConfig, LeakageConfig
from repro_torch.core.p2m_layer import P2MConfig
from repro_torch.core.snn import SpikingCNNConfig
from repro_torch.data.events import EventStreamConfig

# full-scale (DVS128-Gesture geometry)
CONFIG = P2MModelConfig(
    p2m=P2MConfig(out_channels=16, kernel_size=3, stride=1, t_intg_ms=10.0,
                  n_sub=4, leak=LeakageConfig(circuit=CircuitConfig.NULLIFIED)),
    backbone=SpikingCNNConfig(
        in_channels=2, channels=(16, 32, 64, 64), input_hw=(128, 128),
        fc_hidden=512, n_classes=11, first_layer_external=True),
    coarse_window_ms=1000.0,
)

DATA = EventStreamConfig(name="gesture", height=128, width=128, n_classes=11,
                         duration_ms=4000.0)


def reduced(hw: int = 24, channels=(8, 16, 16, 16), fc: int = 64
            ) -> tuple[P2MModelConfig, EventStreamConfig]:
    """CPU-scale variant for smoke tests."""
    cfg = replace(
        CONFIG,
        p2m=replace(CONFIG.p2m, out_channels=channels[0]),
        backbone=replace(CONFIG.backbone, channels=channels,
                         input_hw=(hw, hw), fc_hidden=fc))
    data = replace(DATA, height=hw, width=hw, duration_ms=2000.0)
    return cfg, data
