"""The P²M in-pixel first layer (paper §2 + §4) — ``repro.core.p2m_layer``
in PyTorch.

Between events the kernel capacitor leaks toward V_inf; each event
deposits ``dv_unit · Σ w·s``, compressed by the step non-linearity g(V);
after T_INTG the comparator reads the voltage. Three forms:

  ``mode="scan"``      exact event-driven integration, a Python loop over
                       windows and sub-slots (the hardware simulator);
  ``mode="curvefit"``  the paper's trainable model: a linear conv of the
                       leak-weighted event sum through the fitted transfer
                       curve;
  ``mode="kernel"``    the scan's physics in the hand-written P²M conv
                       kernel (``kernels/p2m_conv``).
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
from repro_torch.kernels.p2m_conv import ops as p2m_ops
from repro_torch.utils import tree_map

Params = dict
MODES = ("curvefit", "scan", "kernel")


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
    mode: str = "curvefit"           # "curvefit" | "scan" | "kernel"

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


def stacked_thetas(cfg: P2MConfig, leak_cfgs: tuple[LeakageConfig, ...],
                   ndim: int, device: torch.device | str = "cpu"
                   ) -> torch.Tensor:
    """Per-variant comparator thresholds, shaped [n_cfg, 1, ..., 1] to
    broadcast against an ``ndim``-dimensional stacked voltage tensor; each
    variant may override the model-level ``cfg.v_threshold``."""
    th = torch.tensor([leakage.resolve_v_threshold(lc, cfg.v_threshold)
                       for lc in leak_cfgs], dtype=torch.float32,
                      device=device)
    return th.reshape((len(leak_cfgs),) + (1,) * (ndim - 1))


def _forward_scan_lk(params: Params, events: torch.Tensor, cfg: P2MConfig,
                     w_q: torch.Tensor, lk: leakage.LeakParams
                     ) -> torch.Tensor:
    """Scan-mode voltage integration for one leak linearization.

    ``lk`` fields are [F] (one config → v_pre [B, T_out, H', W', F]) or
    [n_cfg, 1, 1, 1, F] (a config axis → v_pre [n_cfg, B, T_out, ...]):
    the voltage recursion broadcasts over it while each sub-slot's conv,
    which no config changes, runs once. The windows are a Python loop
    (the reference's ``lax.map``), the sub-slots another (its ``lax.scan``).
    """
    B, T_out, n_sub = events.shape[:3]
    a_cfg = cfg.analog
    decay = leakage.decay_factor(lk.tau_ms, cfg.dt_ms)
    out = None
    for t in range(T_out):
        v = torch.zeros((), device=events.device)
        for s in range(n_sub):
            v = lk.v_inf + (v - lk.v_inf) * decay
            ideal = _conv(events[:, t, s], w_q, cfg.stride) * a_cfg.dv_unit
            step = ideal * analog.step_nonlinearity(v, a_cfg)
            step = step * params["pv_gain"]
            v = torch.clamp(v + step, -a_cfg.v_precharge,
                            a_cfg.vdd - a_cfg.v_precharge)
        v = v + params["pv_offset"]
        if out is None:
            out = v.new_empty(v.shape[:-3] + (T_out,) + v.shape[-3:])
        out.select(-4, t).copy_(v)
    return out


def p2m_forward_scan(params: Params, events: torch.Tensor, cfg: P2MConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact event-driven integration (hardware simulator).

    events [B, T_out, n_sub, H, W, C_in] event counts per sub-slot →
    (spikes, v_pre), both [B, T_out, H', W', C_out]; v_pre is the
    pre-comparator voltage at the end of each integration window.
    """
    spikes, v_pre = p2m_forward_scan_stacked(params, events, cfg,
                                             (cfg.leak,))
    return spikes[0], v_pre[0]


def p2m_forward_scan_stacked(params: Params, events: torch.Tensor,
                             cfg: P2MConfig,
                             leak_cfgs: tuple[LeakageConfig, ...]
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan-mode integration under several circuit configs, on a config
    axis → (spikes, v_pre), both [n_cfg, B, T_out, H', W', C_out]."""
    w_q = effective_weights(params, cfg)
    lk = leakage.stacked_leak_params(w_q, leak_cfgs)          # [n_cfg, F]
    axis = (len(leak_cfgs), 1, 1, 1, cfg.out_channels)
    v_pre = _forward_scan_lk(params, events, cfg, w_q, leakage.LeakParams(
        v_inf=lk.v_inf.reshape(axis), tau_ms=lk.tau_ms.reshape(axis)))
    th = stacked_thetas(cfg, leak_cfgs, v_pre.dim(), v_pre.device)
    return spike_fn(v_pre - th), v_pre


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


def _curvefit_from_lk(params: Params, events: torch.Tensor, cfg: P2MConfig,
                      w_q: torch.Tensor, lk: leakage.LeakParams
                      ) -> torch.Tensor:
    """Single-config curve-fit body for one leak linearization (fields
    [C_out]) → v_pre [B, T_out, H', W', C_out]."""
    ideal = curvefit_ideal(events, cfg, w_q)
    return curvefit_reduce(params, cfg, ideal, lk, events.shape[0])


def p2m_forward_curvefit(params: Params, events: torch.Tensor,
                         cfg: P2MConfig
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's trainable model: leak-weighted linear conv → curve fit.
    Returns (spikes, v_pre), both [B, T_out, H', W', C_out]."""
    w_q = effective_weights(params, cfg)
    lk = leakage.kernel_leak_params(w_q, cfg.leak)
    v_pre = _curvefit_from_lk(params, events, cfg, w_q, lk)
    theta = leakage.resolve_v_threshold(cfg.leak, cfg.v_threshold)
    return spike_fn(v_pre - theta), v_pre


def p2m_forward_curvefit_stacked(params: Params, events: torch.Tensor,
                                 cfg: P2MConfig,
                                 leak_cfgs: tuple[LeakageConfig, ...]
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Curve-fit model under several circuit configs: the per-sub-slot
    ideal conv runs once and each config reduces it with its own decay
    weights (a loop over configs). Returns (spikes, v_pre), both
    [n_cfg, B, T_out, H', W', C_out]."""
    w_q = effective_weights(params, cfg)
    lk = leakage.stacked_leak_params(w_q, leak_cfgs)
    ideal = curvefit_ideal(events, cfg, w_q)
    v_pre = torch.stack([
        curvefit_reduce(params, cfg, ideal, leakage.LeakParams(
            v_inf=lk.v_inf[i], tau_ms=lk.tau_ms[i]), events.shape[0])
        for i in range(len(leak_cfgs))])
    th = stacked_thetas(cfg, leak_cfgs, v_pre.dim(), v_pre.device)
    return spike_fn(v_pre - th), v_pre


def p2m_apply(params: Params, events: torch.Tensor, cfg: P2MConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.mode``. events [B, T_out, n_sub, H, W, C_in] →
    (spikes, v_pre) [B, T_out, H', W', C_out]."""
    if cfg.mode == "scan":
        return p2m_forward_scan(params, events, cfg)
    if cfg.mode == "curvefit":
        return p2m_forward_curvefit(params, events, cfg)
    if cfg.mode == "kernel":
        return p2m_ops.p2m_conv(params, events, cfg)
    raise ValueError(f"unknown mode {cfg.mode!r} (expected one of {MODES})")


def p2m_apply_stacked(params: Params, events: torch.Tensor, cfg: P2MConfig,
                      leak_cfgs: tuple[LeakageConfig, ...]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.mode`` over a circuit-config axis (``leak_cfgs``
    overrides ``cfg.leak``) → (spikes, v_pre), both
    [n_cfg, B, T_out, H', W', C_out]. Mode "kernel" evaluates every
    config in one kernel launch."""
    if cfg.mode == "scan":
        return p2m_forward_scan_stacked(params, events, cfg, leak_cfgs)
    if cfg.mode == "curvefit":
        return p2m_forward_curvefit_stacked(params, events, cfg, leak_cfgs)
    if cfg.mode == "kernel":
        return p2m_ops.p2m_conv_multi(params, events, cfg, leak_cfgs)
    raise ValueError(f"unknown mode {cfg.mode!r} (expected one of {MODES})")


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


def p2m_forward_curvefit_grouped(params_s: Params, events: torch.Tensor,
                                 cfg: P2MConfig,
                                 leak_cfgs: tuple[LeakageConfig, ...]
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Curve-fit forward with per-config layer-1 params (unfrozen phase
    2): every leaf of ``params_s`` carries a leading [n_cfg] axis, and
    config ``i`` re-linearizes its leak from its own weights, so autograd
    gives each config its own layer-1 gradient. Returns (spikes, v_pre),
    both [n_cfg, B, T_out, H', W', C_out]. The reference's ``vmap`` over
    configs is a loop here: each config runs its own conv."""
    out = [p2m_forward_curvefit_coeffs(
        {k: v[i] for k, v in params_s.items()}, events, cfg,
        leakage.leak_coeffs(lc, cfg.v_threshold))
        for i, lc in enumerate(leak_cfgs)]
    return (torch.stack([s for s, _ in out]),
            torch.stack([v for _, v in out]))


def stack_p2m_params(params: Params, n_cfg: int) -> Params:
    """Params replicated onto a leading [n_cfg] config axis — the start of
    the unfrozen phase-2 finetune (every config starts from the shared
    pretrained kernel); any dict tree of tensors, as the sweep stacks the
    backbone and the BN state with it too."""
    return tree_map(lambda v: torch.stack([v] * n_cfg), params)


def coarsen_spikes(spikes: torch.Tensor, group: int) -> torch.Tensor:
    """Sum fine-grid spikes onto the backbone's coarse grid:
    [B, T_fine, ...] → [B, T_fine // group, ...] (multi-bit counts)."""
    B, T = spikes.shape[:2]
    if T % group:
        raise ValueError(f"{T} fine steps do not split into groups of {group}")
    return spikes.reshape((B, T // group, group) + spikes.shape[2:]).sum(dim=2)
