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

:func:`make_multi_stream_fns` serves a registry of compat-equal
deployments from one lane table: each call takes a per-lane ``entry``
index into a stacked numerics ``bundle`` (:func:`stack_entries`), runs
each served entry's full-lane-batch fold and readout, and keeps for every
lane the rows of the entry it is bound to. Lanes never mix, so a lane's
state is bit-identical to a single-variant serve of its entry.

Both take ``executor=`` (``stream/shard.LaneExecutor``): a sharded one
splits the lane axis into contiguous per-device blocks, each shard with
its own lane table and its copy of the numerics on its device, and runs
the fold (one K2 or K3 launch per shard per chunk on ``cuda``) and the
readout shard by shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core import analog, leakage, p2m_layer, snn
from repro_torch.core.sweep_exec import AXIS, REP
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.stream_fold import ops as stream_fold_ops
from repro_torch.stream.deploy import Deployment, tree_to
from repro_torch.stream.shard import LaneExecutor, shard_lane_fns
from repro_torch.utils import tree_map


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


@dataclass(frozen=True)
class MultiStreamFns:
    """The multi-variant serving surface (``stream/registry.py``): ``fold``
    and ``readout`` also take a per-lane ``entry`` index ``[capacity]``
    (host ints) into the ``[E]`` axis of a stacked numerics ``bundle``
    (:func:`stack_entries`). The bundle is an argument, so a hot-swap
    re-stacks it and nothing else changes."""
    init_state: Callable[[], dict]
    reset_lane: Callable[[dict, int], dict]
    fold: Callable[[dict, torch.Tensor, np.ndarray, np.ndarray, dict], dict]
    readout: Callable[[dict, np.ndarray, np.ndarray, np.ndarray, dict],
                      tuple[dict, dict]]
    in_hw: tuple[int, int]
    n_classes: int
    device: torch.device


def relinearized_numerics(w_raw: torch.Tensor,
                          theta: "float | torch.Tensor", *,
                          analog_cfg, coeffs: leakage.LeakCoeffs,
                          n_sub: int, dt_ms: float) -> dict:
    """Quantize the raw layer-1 weights, re-linearize the leak from the
    quantized kernel, and derive the per-filter sub-slot decay ``a`` and
    window ``drift``.

    Differentiable in ``w_raw`` (straight-through quantizer, the branch-free
    ``leak_params_from_coeffs`` with the reference's tie rules) and in
    ``theta`` (a float, or a 0-dim tensor such as one lane's
    ``theta_base + dtheta``): per-lane adaptation (``stream/adapt.py``)
    takes its surrogate gradients through exactly these numerics."""
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


def stack_entries(numerics: list[dict]) -> dict:
    """Stack per-entry numerics trees (:func:`entry_numerics` on one
    device) on a leading ``[E]`` entry axis: the ``bundle`` argument of
    :class:`MultiStreamFns`. Tensor leaves are stacked; any other leaf (the
    ``LeakCoeffs`` of ``adapt.adapt_entry_numerics``) is kept as a list of
    E. All entries must be compat-equal (identical leaf shapes)."""
    if not numerics:
        raise ValueError("cannot stack an empty entry list")

    def stack(*xs):
        if all(isinstance(x, torch.Tensor) for x in xs):
            return torch.stack(xs)
        return list(xs)

    return tree_map(stack, *numerics)


def take_entry(bundle: dict, e: int) -> dict:
    """Entry ``e``'s numerics out of a :func:`stack_entries` bundle."""
    if isinstance(bundle, dict):
        return {k: take_entry(v, e) for k, v in bundle.items()}
    return bundle[e]


def _check_fold_mode(fold_mode: str) -> None:
    if fold_mode not in stream_fold_ops.MODES:
        raise ValueError(f"unknown fold_mode {fold_mode!r} (expected one of "
                         f"{stream_fold_ops.MODES})")


def _fold_core(x: torch.Tensor, frames: torch.Tensor, nb: dict, *,
               stride: int, dv_unit: float, mode: str = "deposit"
               ) -> torch.Tensor:
    """Advance every lane's charge through ``frames`` [capacity,
    chunk_slots, H, W, 2]: each sub-slot decays by ``a`` and deposits its
    dv_unit-scaled conv (empty slots decay without deposit)."""
    return stream_fold_ops.fold_chunk(x, frames, nb["w_q"], nb["a"],
                                      stride=stride, dv_unit=dv_unit,
                                      mode=mode)


def _layer1_readout(x: torch.Tensor, coarse: torch.Tensor, drift, theta,
                    pv: dict, analog_cfg) -> dict:
    """Layer 1 at a T_INTG boundary from the linear charge ``x``: drift,
    transfer curve + PV, comparator, 2x pool, coarse accumulate. Every op
    is elementwise per lane (or a window max), so per-lane ``drift`` /
    ``theta`` / ``pv`` broadcast to the values a shared one gives."""
    v_pre = analog.transfer_curve(x + drift, analog_cfg, pv)
    spikes = snn.spike_fn(v_pre - theta)                      # [B, H, W, C]
    pooled = snn.max_pool(spikes)
    return {"spikes": spikes, "pooled": pooled, "coarse": coarse + pooled}


def backbone_lanes(nb_of: Callable[[int], dict], mem: dict,
                   coarse: torch.Tensor, rows: np.ndarray, bb_cfg
                   ) -> tuple[torch.Tensor, dict]:
    """One backbone step of each lane in ``rows`` (host ints), one lane a
    call, under ``nb_of(lane)``'s weights. A batched step rounds its
    products differently at another batch size (on the CPU the fc0
    product at batch 1; on the card the membranes at 8 lanes against 16),
    so a lane's logits and membranes are kept the same bits whatever lanes
    share its table: a sharded serve equals an unsharded one. The backbone
    steps only at coarse-window boundaries, so the loop is rare. Rows
    outside ``rows`` get zero logits and keep their membranes (the caller
    masks them away)."""
    logits = None
    mem2 = {k: v.clone() for k, v in mem.items()}
    for i in rows:
        i = int(i)
        nb = nb_of(i)
        lg, m = snn.spiking_cnn_stream_step(
            nb["backbone"], nb["bn_state"],
            {k: v[i:i + 1] for k, v in mem.items()}, coarse[i:i + 1], bb_cfg)
        if logits is None:
            logits = lg.new_zeros((coarse.shape[0],) + lg.shape[1:])
        logits[i] = lg[0]
        for k, v in m.items():
            mem2[k][i] = v[0]
    return logits, mem2


def _readout_core(state: dict, nb: dict, *, analog_cfg, bb_cfg,
                  rows: np.ndarray = (), nb_of=None) -> dict:
    """T_INTG readout over every lane: :func:`_layer1_readout`, then one
    backbone step of the lanes ``rows`` (:func:`backbone_lanes`, under
    ``nb_of(lane)``'s weights, default ``nb``). Masking is the caller's
    job."""
    ro = _layer1_readout(state["x"], state["coarse"], nb["drift"],
                         nb["theta"], nb["pv"], analog_cfg)
    if len(rows):
        ro["logits_t"], ro["mem2"] = backbone_lanes(
            nb_of or (lambda _: nb), state["mem"], ro["coarse"], rows,
            bb_cfg)
    return ro


def _commit_readout(state: dict, ro: dict, act: torch.Tensor,
                    cm: torch.Tensor, step: bool) -> tuple[dict, dict]:
    """The readout's state update: ``act`` lanes precharge (x ← 0) and keep
    their coarse counts, ``cm ⊆ act`` lanes (a completed coarse window)
    clear them, take the backbone's membranes and add its logits. Returns
    the new state and the per-lane outputs."""
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


def _lane_table(dep: Deployment, capacity: int, chunk_slots: int,
                dev: torch.device) -> tuple:
    """Geometry checks and ``init_state`` / ``reset_lane`` of a lane table
    serving ``dep``'s compat key on ``dev``."""
    cfg = dep.model_cfg
    p2m_cfg, bb_cfg = cfg.p2m, cfg.backbone
    if p2m_cfg.n_sub % chunk_slots:
        raise ValueError(f"chunk_slots={chunk_slots} must divide "
                         f"n_sub={p2m_cfg.n_sub}")
    H, W = bb_cfg.input_hw
    C = p2m_cfg.out_channels
    s = p2m_cfg.stride
    hp, wp = H // s // 2, W // s // 2                  # post-pool

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
        """Zero one lane's state in place (a newly admitted stream's
        precharge; the state tensors are owned by the serving loop)."""
        for v in (state["x"], state["coarse"], state["logits"],
                  state["n_coarse"], *state["mem"].values()):
            v[lane] = 0
        return state

    def lane_mask(m: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(m, bool), device=dev)

    return init_state, reset_lane, lane_mask


def make_stream_fns(dep: Deployment, *, capacity: int, chunk_slots: int,
                    fold_mode: str = "deposit",
                    device: str | torch.device | None = None,
                    executor: LaneExecutor | None = None) -> StreamFns:
    """Build the lane-batched fold/readout steps for ``dep`` on ``device``.

    ``chunk_slots`` fine sub-slots make one replay chunk (``fold`` takes
    frames ``[capacity, chunk_slots, H, W, 2]``); it must divide ``n_sub``
    so T_INTG boundaries land on chunk boundaries. ``fold_mode`` picks the
    streaming-fold kernel: ``"deposit"`` (conv deposits, then the fold
    kernel) or ``"mac"`` (the conv inside the kernel).

    ``reset_lane`` zeroes one lane's state in place (the state tensors are
    owned by the caller's serving loop, so no copy is needed); ``fold`` and
    ``readout`` return new state dicts.

    A sharded ``executor`` splits the lane axis: ``capacity`` must be a
    multiple of ``executor.devices`` (the engine pads it), each shard runs
    these steps for its lanes on its device, and the state's leaves are
    :class:`~repro_torch.core.sweep_exec.Blocks`.
    """
    dev = resolve_device(device)
    _check_fold_mode(fold_mode)
    if executor is not None and executor.is_sharded:
        return shard_lane_fns(
            executor, capacity, dev,
            lambda cap, place: make_stream_fns(
                dep, capacity=cap, chunk_slots=chunk_slots,
                fold_mode=fold_mode, device=place),
            {"init_state": (), "fold": (AXIS,) * 3,
             "readout": (AXIS,) * 3})
    p2m_cfg, bb_cfg = dep.model_cfg.p2m, dep.model_cfg.backbone
    init_state, reset_lane, lane_mask = _lane_table(dep, capacity,
                                                    chunk_slots, dev)
    with torch.no_grad():
        nb = tree_to(entry_numerics(dep), dev)

    @torch.no_grad()
    def fold(state: dict, frames: torch.Tensor, active: np.ndarray) -> dict:
        """Advance the charge ODE of the ``active`` lanes through one replay
        chunk ``frames`` [capacity, chunk_slots, H, W, 2]."""
        x = _fold_core(state["x"], frames.to(dev), nb,
                       stride=p2m_cfg.stride,
                       dv_unit=p2m_cfg.analog.dv_unit, mode=fold_mode)
        return {**state, "x": _mask(lane_mask(active), x, state["x"])}

    @torch.no_grad()
    def readout(state: dict, active: np.ndarray, coarse_mask: np.ndarray
                ) -> tuple[dict, dict]:
        """T_INTG-boundary readout: ``active`` lanes read out and precharge;
        ``coarse_mask ⊆ active`` lanes completed a coarse window and step
        the backbone and the logit sum. The backbone runs only when some
        lane needs it, and only on those lanes. Returns the new state and
        per-lane outputs."""
        rows = np.flatnonzero(coarse_mask)
        ro = _readout_core(state, nb, analog_cfg=p2m_cfg.analog,
                           bb_cfg=bb_cfg, rows=rows)
        return _commit_readout(state, ro, lane_mask(active),
                               lane_mask(coarse_mask), len(rows) > 0)

    return StreamFns(init_state=init_state, reset_lane=reset_lane, fold=fold,
                     readout=readout, in_hw=bb_cfg.input_hw,
                     n_classes=bb_cfg.n_classes, device=dev)


def served_entries(active: np.ndarray, entry: np.ndarray) -> list[int]:
    """The bundle slots bound to at least one active lane, ascending."""
    act = np.asarray(active, bool)
    return [int(e) for e in np.unique(np.asarray(entry)[act])]


def make_multi_stream_fns(dep: Deployment, *, capacity: int,
                          chunk_slots: int, fold_mode: str = "deposit",
                          device: str | torch.device | None = None,
                          executor: LaneExecutor | None = None
                          ) -> MultiStreamFns:
    """Build the multi-variant fold/readout steps (registry serving).
    ``dep`` is the engine's anchor entry: it pins the shared geometry (the
    compat key); the per-lane numerics come with each call as a stacked
    ``bundle`` and a per-lane ``entry`` index into it.

    For each served entry the steps run the same full-lane-batch program a
    single-variant engine runs with that entry's numerics (on ``cuda`` one
    K2 or K3 launch per served entry per chunk), then keep, per lane, the
    rows of the entry the lane is bound to (the reference's ``lax.map``
    over entries and per-lane gather, as a loop). No op mixes lanes, so
    each lane's state is bit-identical to a single-variant serve of its
    entry. Bundle slots that no active lane is bound to are skipped: the
    gather would never read their rows, and a fold or readout of an
    inactive lane is masked away.

    A sharded ``executor`` splits the lane axis and the per-lane ``entry``
    index as :func:`make_stream_fns` does; the bundle must then be
    ``executor.replicate``-d, every shard carrying all E entries.
    """
    dev = resolve_device(device)
    _check_fold_mode(fold_mode)
    if executor is not None and executor.is_sharded:
        return shard_lane_fns(
            executor, capacity, dev,
            lambda cap, place: make_multi_stream_fns(
                dep, capacity=cap, chunk_slots=chunk_slots,
                fold_mode=fold_mode, device=place),
            {"init_state": (), "fold": (AXIS,) * 4 + (REP,),
             "readout": (AXIS,) * 4 + (REP,)})
    p2m_cfg, bb_cfg = dep.model_cfg.p2m, dep.model_cfg.backbone
    init_state, reset_lane, lane_mask = _lane_table(dep, capacity,
                                                    chunk_slots, dev)

    def bound(active: np.ndarray, entry: np.ndarray, e: int) -> torch.Tensor:
        return lane_mask(np.asarray(active, bool) & (np.asarray(entry) == e))

    @torch.no_grad()
    def fold(state: dict, frames: torch.Tensor, active: np.ndarray,
             entry: np.ndarray, bundle: dict) -> dict:
        """One replay chunk for every active lane, under its entry's
        numerics."""
        frames = frames.to(dev)
        x = state["x"]
        for e in served_entries(active, entry):
            xe = _fold_core(state["x"], frames, take_entry(bundle, e),
                            stride=p2m_cfg.stride,
                            dv_unit=p2m_cfg.analog.dv_unit, mode=fold_mode)
            x = _mask(bound(active, entry, e), xe, x)
        return {**state, "x": x}

    @torch.no_grad()
    def readout(state: dict, active: np.ndarray, coarse_mask: np.ndarray,
                entry: np.ndarray, bundle: dict) -> tuple[dict, dict]:
        """The T_INTG readout of :func:`make_stream_fns`, each lane under its
        entry's numerics."""
        rows = np.flatnonzero(coarse_mask)
        ro = None
        for e in served_entries(active, entry) or [0]:
            # no active lane: every row is masked away, entry 0 stands in
            ro_e = _readout_core(state, take_entry(bundle, e),
                                 analog_cfg=p2m_cfg.analog, bb_cfg=bb_cfg)
            if ro is None:
                ro = ro_e
                continue
            sel = bound(active, entry, e)
            ro = tree_map(lambda new, old: _mask(sel, new, old), ro_e, ro)
        if len(rows):
            nbs = {}
            entry = np.asarray(entry)

            def nb_of(lane: int) -> dict:
                e = int(entry[lane])
                if e not in nbs:
                    nbs[e] = take_entry(bundle, e)
                return nbs[e]

            ro["logits_t"], ro["mem2"] = backbone_lanes(
                nb_of, state["mem"], ro["coarse"], rows, bb_cfg)
        return _commit_readout(state, ro, lane_mask(active),
                               lane_mask(coarse_mask), len(rows) > 0)

    return MultiStreamFns(init_state=init_state, reset_lane=reset_lane,
                          fold=fold, readout=readout, in_hw=bb_cfg.input_hw,
                          n_classes=bb_cfg.n_classes, device=dev)
