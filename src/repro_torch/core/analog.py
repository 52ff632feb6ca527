"""Behavioural model of the in-pixel analog MAC unit (paper §2, Fig 1) —
the PyTorch counterpart of ``repro.core.analog``.

Weights quantize to transistor-geometry levels (straight-through), the
charge step compresses near the rails (cubic curve fit + step
non-linearity), and process variation perturbs each filter's transfer
curve by a gain and an offset.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AnalogConfig:
    """Behavioural parameters of the analog MAC compute unit."""
    vdd: float = 0.8                 # rail voltage (V), 22FDX-ish
    v_precharge: float = 0.4         # capacitor precharge = VDD/2 (mid-rail)
    dv_unit: float = 0.010           # ideal voltage step for |w| = 1 and 1 event (V)
    weight_levels: int = 16          # 4-bit transistor geometry granularity
    w_clip: float = 1.0              # weights clipped to [-w_clip, w_clip]
    c1: float = 0.96                 # cubic curve-fit coefficients
    c3: float = -0.35
    pv_gain_sigma: float = 0.02      # process variation (per-filter sigmas)
    pv_offset_sigma_mv: float = 1.5
    enable_nonlinearity: bool = True
    enable_process_variation: bool = True


def quantize_weights(w: torch.Tensor, cfg: AnalogConfig) -> torch.Tensor:
    """Signed uniform quantization to transistor geometry levels, with a
    straight-through estimator: forward quantized, gradient identity.
    ``torch.round`` rounds half to even, as ``jnp.round`` does. The clip is
    ``jnp.clip``'s ``minimum(maximum(w, lo), hi)``, whose gradient at a
    weight exactly on ``±w_clip`` is 1/2 (``torch.clamp`` would pass 1):
    an adapted weight ``w_q + dw`` sits there whenever ``w_q`` is a rail
    level and ``dw`` is 0. The division is :func:`true_div`, so the levels
    are the same on every device."""
    lim = torch.full((), cfg.w_clip, dtype=w.dtype, device=w.device)
    w = torch.minimum(torch.maximum(w, -lim), lim)
    scale = cfg.w_clip / (cfg.weight_levels // 2)
    q = torch.round(true_div(w, scale)) * scale
    return w + (q - w).detach()


def sample_process_variation(gen: torch.Generator, n_filters: int,
                             cfg: AnalogConfig) -> dict[str, torch.Tensor]:
    """Per-filter (per compute unit) transfer-curve perturbations, drawn
    on the CPU from ``gen``."""
    gain = 1.0 + cfg.pv_gain_sigma * torch.randn(n_filters, generator=gen)
    offset = (cfg.pv_offset_sigma_mv * 1e-3) * torch.randn(n_filters,
                                                           generator=gen)
    if not cfg.enable_process_variation:
        return identity_process_variation(n_filters)
    return {"gain": gain, "offset": offset}


def identity_process_variation(n_filters: int) -> dict[str, torch.Tensor]:
    return {"gain": torch.ones(n_filters), "offset": torch.zeros(n_filters)}


def transfer_curve(x: torch.Tensor, cfg: AnalogConfig,
                   pv: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """Curve fit from the ideal weighted sum (volts of swing) to the
    realised swing; the last axis of ``x`` is the filter axis when ``pv``
    is given."""
    if cfg.enable_nonlinearity:
        half_swing = cfg.vdd / 2.0
        xn = x / half_swing
        y = (cfg.c1 * xn + cfg.c3 * xn ** 3) * half_swing
    else:
        y = x
    if pv is not None:
        y = y * pv["gain"] + pv["offset"]
    # rail clamp: the capacitor voltage cannot leave [0, VDD]
    return torch.clamp(y, -cfg.v_precharge, cfg.vdd - cfg.v_precharge)


def step_nonlinearity(v: torch.Tensor, cfg: AnalogConfig) -> torch.Tensor:
    """Per-event charge-step compression factor g(V) ∈ (0, 1]; ``v`` is the
    swing (0 at precharge)."""
    if not cfg.enable_nonlinearity:
        return torch.ones_like(v)
    return torch.clamp(1.0 - true_div(v, cfg.vdd / 2.0) ** 2, 0.05, 1.0)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, correctly rounded on every device. On CUDA, PyTorch
    divides a tensor by a Python number as a multiply by its reciprocal,
    which can differ from the division in the last bit; dividing by a
    0-dim tensor on ``x``'s device keeps the true division, the rounding
    the P²M conv kernel (``csrc/p2m_conv.cu``) reproduces."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)
