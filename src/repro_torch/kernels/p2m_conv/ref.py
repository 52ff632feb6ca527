"""Plain PyTorch versions of the P²M conv kernel, in patch space (the
counterparts of ``repro.kernels.p2m_conv.ref``).

The CPU path runs these; on the card they are what ``chip_smoke.py``
holds the CUDA kernel against. Each sub-slot's update is written op by op
in the order the kernel reproduces: leak, ideal step, step gain, process
variation gain, rail clamp.
"""
from __future__ import annotations

import torch

from repro_torch.core.analog import true_div


def p2m_conv_ref(patches: torch.Tensor, w: torch.Tensor, v_inf: torch.Tensor,
                 decay: torch.Tensor, theta: torch.Tensor,
                 pv_gain: torch.Tensor, pv_offset: torch.Tensor, **consts
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One config: patches [T, n_sub, P, K], w [K, F], v_inf/decay/theta
    [F] → (spikes, v_pre) [T, P, F]."""
    spikes, v_pre = p2m_conv_multi_ref(patches, w, v_inf[None], decay[None],
                                       theta[None], pv_gain, pv_offset,
                                       **consts)
    return spikes[0], v_pre[0]


def p2m_conv_multi_ref(patches: torch.Tensor, w: torch.Tensor,
                       v_inf: torch.Tensor, decay: torch.Tensor,
                       theta: torch.Tensor, pv_gain: torch.Tensor,
                       pv_offset: torch.Tensor, *, dv_unit: float,
                       half_swing: float, v_lo: float, v_hi: float,
                       nonlinear: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Several configs: v_inf/decay/theta [n_cfg, F] → (spikes, v_pre)
    [n_cfg, T, P, F], float32. The config-independent product
    ``patch @ w`` runs once per sub-slot; the voltages carry a config
    axis. Loops over windows and sub-slots."""
    T, n_sub, P, _ = patches.shape
    n_cfg, F = v_inf.shape
    vi, de = v_inf[:, None, :], decay[:, None, :]
    v_pre = patches.new_empty((n_cfg, T, P, F))
    for t in range(T):
        v = patches.new_zeros((n_cfg, P, F))
        for s in range(n_sub):
            v = vi + (v - vi) * de
            ideal = (patches[t, s] @ w) * dv_unit
            g = (torch.clamp(1.0 - true_div(v, half_swing) ** 2, 0.05, 1.0)
                 if nonlinear else 1.0)
            v = torch.clamp(v + ideal * g * pv_gain, v_lo, v_hi)
        v_pre[:, t] = v + pv_offset
    spikes = (v_pre > theta[:, None, None, :]).to(torch.float32)
    return spikes, v_pre
