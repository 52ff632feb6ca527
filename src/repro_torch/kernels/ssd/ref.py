"""Plain PyTorch version of the SSD kernel (``repro.kernels.ssd.ref``): the
sequential (non-chunked) scan

    state_t = exp(dt_t · A) · state_{t-1} + dt_t · B_t x_tᵀ
    y_t     = C_t · state_t

in float32. The CPU path runs it; on the card it is what
``chip_smoke.py`` holds the CUDA kernel against.
"""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [b,s,h,p]; dt [b,s,h]; A [h]; B, C [b,s,g,n] (h % g == 0).
    Returns (y [b,s,h,p] of x's type, state [b,h,p,n] float32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hr = h // g
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = B.float().repeat_interleave(hr, dim=2)          # [b,s,h,n]
    Cf = C.float().repeat_interleave(hr, dim=2)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af)                # [b,h]
        upd = torch.einsum("bhn,bh,bhp->bhpn", Bf[:, t], dtf[:, t], xf[:, t])
        state = state * decay[..., None, None] + upd
        ys[:, t] = torch.einsum("bhn,bhpn->bhp", Cf[:, t], state)
    return ys.to(x.dtype), state
