"""The P²M in-pixel first layer (paper §2 + §4), curve-fit form — the
serving half of ``repro.core.p2m_layer`` in PyTorch.

Between events the kernel capacitor leaks toward V_inf; each event
deposits ``dv_unit · Σ w·s``; after T_INTG the voltage goes through the
fitted transfer curve and the comparator. The curve-fit model folds the
leak into per-sub-slot decay weights of a linear conv.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import analog, leakage
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.leakage import LeakageConfig
# the SAME-padded NHWC/HWIO conv the reference's ``_conv`` runs
from repro_torch.core.snn import conv_same as _conv  # noqa: F401
from repro_torch.core.snn import spike_fn

Params = dict


@dataclass(frozen=True)
class P2MConfig:
    in_channels: int = 2             # DVS ON/OFF
    out_channels: int = 16           # "fewer channels in the first layer"
    kernel_size: int = 3
    stride: int = 1
    t_intg_ms: float = 10.0          # integration time per output activation
    n_sub: int = 8                   # event sub-slots per integration window
    v_threshold: float = leakage.DEFAULT_V_THRESHOLD
    analog: AnalogConfig = field(default_factory=AnalogConfig)
    leak: LeakageConfig = field(default_factory=LeakageConfig)
    # kept so reference checkpoints round-trip; the port serves "curvefit"
    mode: str = "curvefit"

    @property
    def dt_ms(self) -> float:
        return self.t_intg_ms / self.n_sub


def p2m_init(gen: torch.Generator, cfg: P2MConfig) -> Params:
    k = cfg.kernel_size
    fan_in = k * k * cfg.in_channels
    w = torch.randn((k, k, cfg.in_channels, cfg.out_channels),
                    generator=gen) * (2.0 / fan_in) ** 0.5
    pv = analog.sample_process_variation(gen, cfg.out_channels, cfg.analog)
    return {"w": w, "pv_gain": pv["gain"], "pv_offset": pv["offset"]}


def effective_weights(params: Params, cfg: P2MConfig) -> torch.Tensor:
    """Quantized (transistor-geometry) weights, straight-through grads."""
    return analog.quantize_weights(params["w"], cfg.analog)


def curvefit_ideal(events: torch.Tensor, cfg: P2MConfig, w_q: torch.Tensor
                   ) -> torch.Tensor:
    """Per-sub-slot ideal conv: events [B, T_out, n_sub, H, W, C_in] →
    [B·T_out, n_sub, H', W', C_out]."""
    B, T_out, n_sub = events.shape[:3]
    tb = events.reshape((B * T_out * n_sub,) + events.shape[3:])
    ideal = _conv(tb, w_q, cfg.stride) * cfg.analog.dv_unit
    return ideal.reshape((B * T_out, n_sub) + ideal.shape[1:])


def window_decay(lk: leakage.LeakParams, n_sub: int, dt_ms: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One window's leak weighting: per-sub-slot decay weights
    ``a^(n_sub-1-k)`` and the window drift toward ``V_inf``. Shared by the
    offline reduce and the online accumulator.

    Returns ``(decay_w [n_sub, C_out], drift [C_out])``.
    """
    a = leakage.decay_factor(lk.tau_ms, dt_ms)
    k = torch.arange(n_sub, device=a.device)
    decay_w = a[None, :] ** (n_sub - 1 - k).to(a.dtype)[:, None]
    drift = torch.sum(1.0 - decay_w, dim=0) * lk.v_inf / n_sub
    return decay_w, drift


def curvefit_reduce(params: Params, cfg: P2MConfig, ideal: torch.Tensor,
                    lk: leakage.LeakParams, batch: int) -> torch.Tensor:
    """Leak-decay weighting of the precomputed ideal conv + the fitted
    transfer curve → v_pre [B, T_out, H', W', C_out]."""
    decay_w, drift = window_decay(lk, ideal.shape[1], cfg.dt_ms)
    x = torch.einsum("bkhwc,kc->bhwc", ideal, decay_w) + drift
    pv = {"gain": params["pv_gain"], "offset": params["pv_offset"]}
    v_pre = analog.transfer_curve(x, cfg.analog, pv)
    return v_pre.reshape((batch, ideal.shape[0] // batch) + v_pre.shape[1:])


def p2m_forward_curvefit_coeffs(params: Params, events: torch.Tensor,
                                cfg: P2MConfig, coeffs: leakage.LeakCoeffs
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Curve-fit forward with the leak re-linearized from the current
    quantized weights. Returns (spikes, v_pre), both
    [B, T_out, H', W', C_out]."""
    w_q = effective_weights(params, cfg)
    lk = leakage.leak_params_from_coeffs(w_q, coeffs)
    ideal = curvefit_ideal(events, cfg, w_q)
    v_pre = curvefit_reduce(params, cfg, ideal, lk, events.shape[0])
    return spike_fn(v_pre - coeffs.v_threshold), v_pre


def coarsen_spikes(spikes: torch.Tensor, group: int) -> torch.Tensor:
    """Sum fine-grid spikes onto the backbone's coarse grid:
    [B, T_fine, ...] → [B, T_fine // group, ...] (multi-bit counts)."""
    B, T = spikes.shape[:2]
    if T % group:
        raise ValueError(f"{T} fine steps do not split into groups of {group}")
    return spikes.reshape((B, T // group, group) + spikes.shape[2:]).sum(dim=2)
