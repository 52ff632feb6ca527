"""Plain PyTorch version of the LIF kernel (``repro.kernels.lif.ref``).

The CPU path runs it; on the card it is what ``chip_smoke.py`` holds the
CUDA kernel against. ``tau`` and ``v_th`` enter as 0-dim tensors of the
input's type on its device: every op then rounds to that type (float32 or
bfloat16) as eager PyTorch does, and ``/ tau`` stays a true division on
CUDA too, where a Python divisor would become a reciprocal multiply.
"""
from __future__ import annotations

import torch


def lif_ref(x: torch.Tensor, *, tau: float = 2.0, v_th: float = 1.0,
            soft_reset: bool = True) -> torch.Tensor:
    """x [T, N] input currents → spikes [T, N] of x's type:
    ``v ← v + (x − v)/tau``, ``s = v > v_th``, then a soft (subtract
    ``v_th``) or hard (to 0) reset."""
    tau_t = torch.full((), tau, dtype=x.dtype, device=x.device)
    vth_t = torch.full((), v_th, dtype=x.dtype, device=x.device)
    v = torch.zeros_like(x[0])
    out = torch.empty_like(x)
    for t in range(x.shape[0]):
        v = v + (x[t] - v) / tau_t
        s = (v > vth_t).to(x.dtype)
        v = v - s * vth_t if soft_reset else v * (1.0 - s)
        out[t] = s
    return out
