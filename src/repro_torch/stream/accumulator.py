"""Leak-aware online charge accumulation: the lane-batched fold and readout
steps behind the streaming engine (``repro.stream.accumulator`` for one
deployment, in PyTorch).

Each serving lane carries the linear charge ``x`` of one stream's pixel
array; every arriving sub-slot of events advances the exact leak ODE and
deposits its conv contribution,

    x ← x · a + conv(events_k) · dv_unit,     a = e^(−dt/τ)  per filter,

which telescopes to the offline curve-fit forward's decay weighting. At
each T_INTG boundary :func:`make_stream_fns`'s ``readout`` adds the
window drift, applies the transfer curve + process variation and the
comparator, 2x-pools the spikes toward the backbone's coarse grid and, on
lanes finishing a coarse window, steps the spiking backbone and the
rate-decoding logit sum. The capacitor precharges (x ← 0) after every
readout. Everything is masked per lane, so one fixed-shape step serves a
lane table whose streams start and finish independently.

On ``cuda`` the fold is one hand-written kernel launch per chunk
(``kernels/stream_fold``); on the CPU it is the kernel's plain version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core import analog, leakage, p2m_layer, snn
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.stream_fold import ops as stream_fold_ops
from repro_torch.stream.deploy import Deployment, tree_to


def _mask(m: torch.Tensor, new: torch.Tensor, old: torch.Tensor
          ) -> torch.Tensor:
    """Per-lane select: lanes where ``m`` take ``new``, others ``old``."""
    return torch.where(m.reshape(m.shape + (1,) * (new.dim() - 1)), new, old)


@dataclass(frozen=True)
class StreamFns:
    """The serving surface for one deployment × lane capacity. ``state`` is
    a dict of tensors batched on the leading lane axis; the lane masks are
    host-side bool arrays."""
    init_state: Callable[[], dict]
    reset_lane: Callable[[dict, int], dict]
    fold: Callable[[dict, torch.Tensor, np.ndarray], dict]
    readout: Callable[[dict, np.ndarray, np.ndarray], tuple[dict, dict]]
    in_hw: tuple[int, int]       # event-frame resolution the lanes consume
    n_classes: int
    device: torch.device


def relinearized_numerics(w_raw: torch.Tensor, theta: float, *,
                          analog_cfg, coeffs: leakage.LeakCoeffs,
                          n_sub: int, dt_ms: float) -> dict:
    """Quantize the raw layer-1 weights, re-linearize the leak from the
    quantized kernel, and derive the per-filter sub-slot decay ``a`` and
    window ``drift`` (forward only)."""
    w_q = analog.quantize_weights(w_raw, analog_cfg)
    lk = leakage.leak_params_from_coeffs(w_q, coeffs)
    a = leakage.decay_factor(lk.tau_ms, dt_ms)
    _, drift = p2m_layer.window_decay(lk, n_sub, dt_ms)
    return {"w_q": w_q, "a": a, "drift": drift, "theta": theta}


def entry_numerics(dep: Deployment) -> dict:
    """The deployed variant's serving numerics on ``dep.device``: quantized
    layer-1 weights, sub-slot decay ``a``, window drift, transfer-curve
    process variation, comparator threshold, backbone params and BN state."""
    p2m_cfg = dep.model_cfg.p2m
    coeffs = dep.coeffs
    nb = relinearized_numerics(
        dep.params["p2m"]["w"], coeffs.v_threshold,
        analog_cfg=p2m_cfg.analog, coeffs=coeffs,
        n_sub=p2m_cfg.n_sub, dt_ms=p2m_cfg.dt_ms)
    return {
        **nb,
        "pv": {"gain": dep.params["p2m"]["pv_gain"],
               "offset": dep.params["p2m"]["pv_offset"]},
        "backbone": dep.params["backbone"],
        "bn_state": dep.bn_state,
    }


def _fold_core(x: torch.Tensor, frames: torch.Tensor, nb: dict, *,
               stride: int, dv_unit: float, mode: str = "deposit"
               ) -> torch.Tensor:
    """Advance every lane's charge through ``frames`` [capacity,
    chunk_slots, H, W, 2]: each sub-slot decays by ``a`` and deposits its
    dv_unit-scaled conv (empty slots decay without deposit)."""
    return stream_fold_ops.fold_chunk(x, frames, nb["w_q"], nb["a"],
                                      stride=stride, dv_unit=dv_unit,
                                      mode=mode)


def _readout_core(state: dict, nb: dict, *, analog_cfg, bb_cfg,
                  step_backbone: bool = True) -> dict:
    """T_INTG readout over every lane: drift, transfer curve + PV,
    comparator, 2x pool, coarse accumulate and (``step_backbone``) one
    backbone step. Masking is the caller's job."""
    v_pre = analog.transfer_curve(state["x"] + nb["drift"], analog_cfg,
                                  nb["pv"])
    spikes = snn.spike_fn(v_pre - nb["theta"])                # [B, H, W, C]
    pooled = snn.max_pool(spikes)
    coarse = state["coarse"] + pooled
    ro = {"spikes": spikes, "pooled": pooled, "coarse": coarse}
    if step_backbone:
        ro["logits_t"], ro["mem2"] = snn.spiking_cnn_stream_step(
            nb["backbone"], nb["bn_state"], state["mem"], coarse, bb_cfg)
    return ro


def make_stream_fns(dep: Deployment, *, capacity: int, chunk_slots: int,
                    fold_mode: str = "deposit",
                    device: str | torch.device | None = None) -> StreamFns:
    """Build the lane-batched fold/readout steps for ``dep`` on ``device``.

    ``chunk_slots`` fine sub-slots make one replay chunk (``fold`` takes
    frames ``[capacity, chunk_slots, H, W, 2]``); it must divide ``n_sub``
    so T_INTG boundaries land on chunk boundaries. ``fold_mode`` picks the
    streaming-fold kernel: ``"deposit"`` (conv deposits, then the fold
    kernel) or ``"mac"`` (the conv inside the kernel).

    ``reset_lane`` zeroes one lane's state in place (the state tensors are
    owned by the caller's serving loop, so no copy is needed); ``fold`` and
    ``readout`` return new state dicts.
    """
    dev = resolve_device(device)
    if fold_mode not in stream_fold_ops.MODES:
        raise ValueError(f"unknown fold_mode {fold_mode!r} (expected one of "
                         f"{stream_fold_ops.MODES})")
    cfg = dep.model_cfg
    p2m_cfg = cfg.p2m
    bb_cfg = cfg.backbone
    if p2m_cfg.n_sub % chunk_slots:
        raise ValueError(f"chunk_slots={chunk_slots} must divide "
                         f"n_sub={p2m_cfg.n_sub}")
    H, W = bb_cfg.input_hw
    C = p2m_cfg.out_channels
    s = p2m_cfg.stride
    hp, wp = H // s // 2, W // s // 2                  # post-pool
    with torch.no_grad():
        nb = tree_to(entry_numerics(dep), dev)

    def lane_mask(m: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(m, bool), device=dev)

    def init_state() -> dict:
        return {
            "x": torch.zeros((capacity, H // s, W // s, C), device=dev),
            "coarse": torch.zeros((capacity, hp, wp, C), device=dev),
            "mem": snn.spiking_cnn_stream_init(bb_cfg, capacity, dev),
            "logits": torch.zeros((capacity, bb_cfg.n_classes), device=dev),
            "n_coarse": torch.zeros((capacity,), dtype=torch.int32,
                                    device=dev),
        }

    def reset_lane(state: dict, lane: int) -> dict:
        """Zero one lane's state (a newly admitted stream's precharge)."""
        for v in (state["x"], state["coarse"], state["logits"],
                  state["n_coarse"], *state["mem"].values()):
            v[lane] = 0
        return state

    @torch.no_grad()
    def fold(state: dict, frames: torch.Tensor, active: np.ndarray) -> dict:
        """Advance the charge ODE of the ``active`` lanes through one replay
        chunk ``frames`` [capacity, chunk_slots, H, W, 2]."""
        x = _fold_core(state["x"], frames.to(dev), nb, stride=s,
                       dv_unit=p2m_cfg.analog.dv_unit, mode=fold_mode)
        return {**state, "x": _mask(lane_mask(active), x, state["x"])}

    @torch.no_grad()
    def readout(state: dict, active: np.ndarray, coarse_mask: np.ndarray
                ) -> tuple[dict, dict]:
        """T_INTG-boundary readout: ``active`` lanes read out and precharge;
        ``coarse_mask ⊆ active`` lanes completed a coarse window and step
        the backbone and the logit sum. The backbone runs only when some
        lane needs it — the other lanes' results are masked away either
        way. Returns the new state and per-lane outputs."""
        step = bool(np.any(coarse_mask))
        ro = _readout_core(state, nb, analog_cfg=p2m_cfg.analog,
                           bb_cfg=bb_cfg, step_backbone=step)
        act, cm = lane_mask(active), lane_mask(coarse_mask)
        coarse = ro["coarse"]
        new_state = {
            "x": _mask(act, torch.zeros_like(state["x"]), state["x"]),
            "coarse": _mask(act, _mask(cm, torch.zeros_like(coarse), coarse),
                            state["coarse"]),
            "mem": state["mem"],
            "logits": state["logits"],
            "n_coarse": state["n_coarse"] + cm.to(torch.int32),
        }
        if step:
            new_state["mem"] = {k: _mask(cm, v, state["mem"][k])
                                for k, v in ro["mem2"].items()}
            new_state["logits"] = state["logits"] + _mask(
                cm, ro["logits_t"], torch.zeros_like(ro["logits_t"]))
        pooled = ro["pooled"]
        out = {"spikes": ro["spikes"],
               "n_spikes": pooled.sum(dim=(1, 2, 3)) * act.to(pooled.dtype)}
        return new_state, out

    return StreamFns(init_state=init_state, reset_lane=reset_lane, fold=fold,
                     readout=readout, in_hw=(H, W),
                     n_classes=bb_cfg.n_classes, device=dev)
