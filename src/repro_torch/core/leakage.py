"""Leakage models for the three MAC circuit configs (paper §4, Fig 3/4) —
the PyTorch counterpart of ``repro.core.leakage``.

Every circuit reduces to the linear ODE dV/dt = -(V - V_inf)/tau between
events, integrated exactly with exp(-dt/tau) decay factors. Config (a)
leaks through the weight transistors (kernel-dependent V_inf and tau),
(b) through the isolation switch toward GND, (c) is (b) cancelled by the
nullifying current source up to a mismatch fraction.
"""
from __future__ import annotations

import enum
import functools
import math
from collections.abc import Sequence
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

# default comparator threshold on the swing (V)
DEFAULT_V_THRESHOLD = 0.015
# seed of the frozen per-filter process-variation draw behind the sigma axis
_TAU_SIGMA_SEED = 0x5159


class CircuitConfig(enum.Enum):
    BASIC = "a"            # Fig 3a — leak through weight transistors
    SWITCH = "b"           # Fig 3b — + M_SW isolation switch
    NULLIFIED = "c"        # Fig 3c — + I_NULL nullifying current source
    IDEAL = "ideal"        # no leakage (algorithm-only reference)


@dataclass(frozen=True)
class LeakageConfig:
    circuit: CircuitConfig = CircuitConfig.NULLIFIED
    vdd: float = 0.8
    v_precharge: float = 0.4
    tau0_a_ms: float = 1.2          # config (a): tau at mean |w| = 1
    tau_b_ms: float = 60.0          # config (b): switch subthreshold leak
    null_mismatch: float = 0.06     # config (c): residual current mismatch
    w_eps: float = 1e-3
    # comparator threshold override for this variant (None → model default)
    v_threshold: float | None = None
    # process-variation sigma on the leak time constants
    sigma: float = 0.0


@dataclass(frozen=True)
class LeakParams:
    """Per-kernel leak linearization dV/dt = -(V - v_inf)/tau; ``v_inf`` in
    swing coordinates, both fields per filter."""
    v_inf: torch.Tensor
    tau_ms: torch.Tensor


@dataclass(frozen=True)
class LeakCoeffs:
    """Branch-free numeric encoding of one :class:`LeakageConfig` (float32
    scalars, as the reference folds them); :func:`stacked_leak_coeffs`
    holds several configs as float32 tensors on a leading [n_cfg] axis."""
    is_basic: float
    vdd: float
    v_precharge: float
    tau0_a_ms: float
    w_eps: float
    tau_const: float
    v_inf_const: float
    v_threshold: float
    sigma: float


def resolve_v_threshold(cfg: LeakageConfig,
                        default: float = DEFAULT_V_THRESHOLD) -> float:
    """The variant's comparator threshold: its override, else ``default``."""
    return default if cfg.v_threshold is None else cfg.v_threshold


def _f32(x: float) -> float:
    return float(np.float32(x))


def leak_coeffs(cfg: LeakageConfig,
                default_v_threshold: float = DEFAULT_V_THRESHOLD
                ) -> LeakCoeffs:
    """Fold one config's circuit branch into numeric coefficients."""
    if cfg.circuit == CircuitConfig.BASIC:
        is_basic, tau_const, v_inf_const = 1.0, math.inf, 0.0
    elif cfg.circuit == CircuitConfig.SWITCH:
        is_basic, tau_const, v_inf_const = 0.0, cfg.tau_b_ms, -cfg.v_precharge
    elif cfg.circuit == CircuitConfig.NULLIFIED:
        # residual = (b) leak scaled by mismatch → tau lengthens by 1/mismatch
        is_basic = 0.0
        tau_const = cfg.tau_b_ms / max(cfg.null_mismatch, 1e-6)
        v_inf_const = -cfg.v_precharge
    elif cfg.circuit == CircuitConfig.IDEAL:
        is_basic, tau_const, v_inf_const = 0.0, math.inf, 0.0
    else:  # pragma: no cover
        raise ValueError(cfg.circuit)
    return LeakCoeffs(
        is_basic=_f32(is_basic), vdd=_f32(cfg.vdd),
        v_precharge=_f32(cfg.v_precharge), tau0_a_ms=_f32(cfg.tau0_a_ms),
        w_eps=_f32(cfg.w_eps), tau_const=_f32(tau_const),
        v_inf_const=_f32(v_inf_const),
        v_threshold=_f32(resolve_v_threshold(cfg, default_v_threshold)),
        sigma=_f32(cfg.sigma))


def stacked_leak_coeffs(cfgs: Sequence[LeakageConfig],
                        default_v_threshold: float = DEFAULT_V_THRESHOLD
                        ) -> LeakCoeffs:
    """Coefficients of several configs, each field a float32 tensor on a
    leading [n_cfg] axis."""
    per = [leak_coeffs(c, default_v_threshold) for c in cfgs]
    return LeakCoeffs(**{f.name: torch.tensor(
        [getattr(co, f.name) for co in per], dtype=torch.float32)
        for f in fields(LeakCoeffs)})


@functools.lru_cache(maxsize=None)
def _tau_sigma_units(n_filters: int) -> np.ndarray:
    """Frozen per-filter standard-normal draw behind the process-variation
    sigma axis — the reference's numpy draw, reproduced exactly."""
    z = np.random.default_rng(_TAU_SIGMA_SEED).standard_normal(n_filters)
    return np.asarray(z, np.float32)


def leak_params_from_coeffs(w: torch.Tensor, co: LeakCoeffs) -> LeakParams:
    """Branch-free leak linearization from kernel weights ``w``
    [..., n_filters] (reduced over all leading axes); differentiable
    w.r.t. ``w``. Sigma scales each filter's tau by ``exp(sigma * z_f)``."""
    reduce_axes = tuple(range(w.dim() - 1))
    # at a weight quantized to exactly 0 the gradients follow JAX's:
    # torch.maximum splits a tie in half as jnp.maximum does (clamp would
    # pass it whole), and |w| takes slope 1 at 0 as jnp.abs does
    # (torch.abs takes 0)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    pos = torch.sum(torch.maximum(w, zero), dim=reduce_axes)
    neg = torch.sum(torch.maximum(-w, zero), dim=reduce_axes)
    mean_abs = torch.mean(torch.where(w >= 0, w, -w), dim=reduce_axes)
    v_inf_basic = co.vdd * pos / (pos + neg + co.w_eps) - co.v_precharge
    tau_basic = co.tau0_a_ms / torch.maximum(mean_abs, zero + co.w_eps)
    if co.is_basic > 0.5:
        v_inf, tau = v_inf_basic, tau_basic
    else:
        v_inf = torch.full_like(v_inf_basic, co.v_inf_const)
        tau = torch.full_like(tau_basic, co.tau_const)
    z = torch.as_tensor(_tau_sigma_units(w.shape[-1]), device=w.device)
    tau = tau * torch.exp(co.sigma * z)
    return LeakParams(v_inf=v_inf, tau_ms=tau)


def kernel_leak_params(w: torch.Tensor, cfg: LeakageConfig) -> LeakParams:
    """Per-filter leak linearization of ``cfg`` from kernel weights."""
    return leak_params_from_coeffs(w, leak_coeffs(cfg))


def stacked_leak_params(w: torch.Tensor, cfgs: Sequence[LeakageConfig]
                        ) -> LeakParams:
    """Leak linearizations of several circuit configs from one kernel,
    stacked on a leading config axis: fields [n_cfg, ...filters]."""
    per = [kernel_leak_params(w, c) for c in cfgs]
    return LeakParams(v_inf=torch.stack([p.v_inf for p in per]),
                      tau_ms=torch.stack([p.tau_ms for p in per]))


def grouped_leak_params(w_s: torch.Tensor, cfgs: Sequence[LeakageConfig]
                        ) -> LeakParams:
    """Leak linearizations for per-config kernel weights: ``w_s`` has a
    leading [n_cfg] axis (one kernel per circuit config, the unfrozen
    phase-2 state) and config ``i`` is linearized around ``w_s[i]``.
    Fields [n_cfg, ...filters]; differentiable w.r.t. ``w_s``. The
    reference's ``vmap`` over the config axis is a loop over configs
    here (n_cfg is a handful; each linearization is a few reductions)."""
    if w_s.shape[0] != len(cfgs):
        raise ValueError(f"w_s has {w_s.shape[0]} kernels for {len(cfgs)} "
                         f"configs")
    per = [leak_params_from_coeffs(w_s[i], leak_coeffs(c))
           for i, c in enumerate(cfgs)]
    return LeakParams(v_inf=torch.stack([p.v_inf for p in per]),
                      tau_ms=torch.stack([p.tau_ms for p in per]))


def paper_circuits() -> tuple[LeakageConfig, ...]:
    """The paper's three MAC circuit configs (Fig 3a/3b/3c) with the
    defaults used throughout."""
    return (LeakageConfig(circuit=CircuitConfig.BASIC),
            LeakageConfig(circuit=CircuitConfig.SWITCH),
            LeakageConfig(circuit=CircuitConfig.NULLIFIED))


def with_mismatch(cfg: LeakageConfig, mismatch: float) -> LeakageConfig:
    """A copy of ``cfg`` with the nullifier mismatch overridden."""
    return replace(cfg, null_mismatch=mismatch)


def decay_factor(tau_ms: torch.Tensor, dt_ms: float) -> torch.Tensor:
    """exp(-dt/tau), exactly 1 at tau = inf."""
    return torch.where(torch.isinf(tau_ms), torch.ones_like(tau_ms),
                       torch.exp(-dt_ms / torch.clamp(tau_ms, min=1e-9)))


def leak_step(v: torch.Tensor, params: LeakParams, dt_ms: float
              ) -> torch.Tensor:
    """Integrate the leak ODE exactly over dt: V ← V_inf + (V - V_inf)e^{-dt/τ}."""
    a = decay_factor(params.tau_ms, dt_ms)
    return params.v_inf + (v - params.v_inf) * a


def retention_error(params: LeakParams, v0: float | torch.Tensor,
                    t_ms: float) -> torch.Tensor:
    """|V(t) - V(0)| with no input drive (the Fig 4a experiment)."""
    return torch.abs(leak_step(v0, params, t_ms) - v0)


def retention_traces(w: torch.Tensor, cfgs: Sequence[LeakageConfig],
                     ts_ms: Sequence[float], v0: float = 0.2
                     ) -> torch.Tensor:
    """Undriven voltage traces V(t) for each circuit config (Fig 4a):
    ``[n_cfg, n_t, F]`` voltages starting from swing ``v0``. The
    reference's ``vmap`` over ``ts_ms`` is a loop over them here."""
    lk = stacked_leak_params(w, cfgs)
    v0_t = torch.full_like(lk.v_inf, v0)
    return torch.stack([leak_step(v0_t, lk, t) for t in ts_ms], dim=1)


def retention_surface(w: torch.Tensor, cfgs: Sequence[LeakageConfig],
                      t_grid_ms: Sequence[float], v0: float = 0.2
                      ) -> torch.Tensor:
    """Mean retention error |V(t)-V(0)| per (config, T_INTG): the
    ``[n_cfg, n_t]`` surface the sweep artifact reports."""
    traces = retention_traces(w, cfgs, t_grid_ms, v0)
    return torch.mean(torch.abs(traces - v0), dim=-1)
