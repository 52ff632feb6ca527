"""The LIF op shaped like ``core.snn.lif_over_time``
(``repro.kernels.lif.ops`` in PyTorch): an inference drop-in, forward only,
with no surrogate gradient. On CUDA tensors it launches the hand-written
kernel, on the CPU it runs the plain version."""
from __future__ import annotations

import torch

from repro_torch.core.snn import LIFConfig
from repro_torch.kernels.lif.lif import lif


def lif_over_time(x: torch.Tensor, cfg: LIFConfig = LIFConfig()
                  ) -> torch.Tensor:
    """x [T, B, ...] → spikes [T, B, ...] of x's type."""
    flat = x.reshape(x.shape[0], -1).contiguous()
    out = lif(flat, tau=cfg.tau, v_th=cfg.v_threshold,
              soft_reset=cfg.soft_reset)
    return out.reshape(x.shape)
