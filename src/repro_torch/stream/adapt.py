"""Per-lane online adaptation: local plasticity through the serving path
(``repro.stream.adapt`` in PyTorch).

A deployed sensor's leak drifts with temperature and fab corner, and the
weights it was deployed with stop matching the capacitors they drive.
Each serving lane (one sensor) learns its own layer-1 weight and
comparator-threshold deltas while it serves, the online analogue of the
unfrozen training protocol.

Each lane carries, on the ``[capacity, ...]`` lane axis:

- ``dw``/``dtheta``: persistent deltas, served as ``quantize(w_q + dw)``
  (straight-through) and ``theta + dtheta``. They survive stream turnover
  on the lane and reset when it rebinds to another registry entry.
- ``ev``: a per-filter decay-weighted event accumulator
  ``E_f ← E_f · a_f + ev_k``, folded beside the charge and precharged with
  it, so the readout recomputes the window's linear charge from the raw
  events under the current weights and differentiates through it.
- ``elig_w``/``elig_theta``: eligibility traces of the reward rule;
  ``n_updates`` counts applied updates.

At each coarse-window readout the rule takes a depth-1 surrogate gradient
through the serving numerics (re-quantize, re-linearize the leak, drift,
transfer curve, ATan surrogate spike, pool, backbone step;
``accumulator.relinearized_numerics``) and applies either ``surrogate``
(gradient descent on the window's cross-entropy against the stream's label)
or ``reward`` (the gradient toward the lane's own prediction accumulates
into a trace that a ±1 reward gates into the weights).

The reference takes the per-lane gradients with ``jax.vmap(jax.grad)``.
Here each lane takes one backward pass of its own: nothing in the readout
reduces across lanes (BN runs on its running statistics), and a lane's
gradient then has the same bits whatever lanes share its table, sharded
or not (a batched pass rounds differently at another batch size).

Adaptation runs its own eager per-lane fold, as the reference runs its XLA
scan: the streaming-fold kernels (K2/K3) share one weight tensor across
lanes and have no backward, so asking for a kernel fold mode with
adaptation raises rather than serving without learning.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.snn import same_pads
from repro_torch.core.sweep_exec import AXIS, REP
from repro_torch.kernels.backend import resolve_device
from repro_torch.stream.accumulator import (_commit_readout, _layer1_readout,
                                            _mask, backbone_lanes,
                                            entry_numerics,
                                            make_multi_stream_fns,
                                            make_stream_fns,
                                            relinearized_numerics,
                                            take_entry)
from repro_torch.stream.deploy import Deployment, tree_to
from repro_torch.stream.shard import LaneExecutor, shard_lane_fns

RULES = ("surrogate", "reward")

# per-stream transients: reset at every admission. dw/dtheta/n_updates
# persist across streams on a lane and reset only on entry rebind.
_TRANSIENT = ("elig_w", "elig_theta", "ev")


@dataclass(frozen=True)
class AdaptConfig:
    """Local-rule hyperparameters (one config for the whole fleet; the
    state is per lane)."""
    rule: str = "surrogate"          # "surrogate" | "reward"
    lr_w: float = 5e-3               # weight-delta learning rate
    lr_theta: float = 0.0            # threshold-delta learning rate
    trace_decay: float = 0.9         # eligibility-trace decay (reward rule)
    clip_w: float = 0.5              # |dw| bound (keeps quantizer in range)
    clip_theta: float = 0.05         # |dtheta| bound (volts)

    def __post_init__(self) -> None:
        if self.rule not in RULES:
            raise ValueError(f"adapt rule must be one of {RULES}, "
                             f"got {self.rule!r}")
        if self.lr_w < 0 or self.lr_theta < 0:
            raise ValueError("learning rates must be >= 0")
        if self.clip_w <= 0 or self.clip_theta <= 0:
            raise ValueError("delta clips must be > 0")


@dataclass(frozen=True)
class AdaptFns:
    """Adaptation-enabled serving steps, in place of StreamFns /
    MultiStreamFns when a StreamEngine runs with ``adapt=``: ``fold`` and
    ``readout`` thread the adaptation state beside the serving state, and
    registry engines append ``(entry, bundle)``."""
    init_state: Callable[[], dict]
    init_adapt: Callable[[], dict]
    reset_lane: Callable[..., dict]
    reset_lane_transient: Callable[..., dict]
    reset_lane_full: Callable[..., dict]
    fold: Callable[..., tuple]
    readout: Callable[..., tuple]
    in_hw: tuple[int, int]
    n_classes: int
    device: torch.device


def adapt_entry_numerics(dep: Deployment,
                         device: str | torch.device | None = None) -> dict:
    """:func:`~repro_torch.stream.accumulator.entry_numerics` on ``device``
    plus the entry's ``LeakCoeffs``: adaptation re-linearizes the leak from
    each lane's current weights, so it needs the circuit's constants, not
    only the derived ``a`` and ``drift``."""
    with torch.no_grad():
        nb = tree_to(entry_numerics(dep), torch.device(device or dep.device))
    return {**nb, "coeffs": dep.coeffs}


def lane_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME conv of every lane with its own weights: x [N, L, H, W, C], w
    [L, k, k, C, F] → [N, L, H', W', F]. Summed tap by tap (kh, kw, C) in
    a fixed order with elementwise products, so a lane's sums are the same
    whatever the number of lanes in the call (a conv grouped by lane picks
    its algorithm by the group count, and an adapted weight
    ``quantize(w_q + dw)`` is off the level grid by its straight-through
    roundoff, so the order of its sums shows)."""
    N, L, H, W, C = x.shape
    k = w.shape[1]
    pt, pb = same_pads(H, k, stride)
    pl, pr = same_pads(W, k, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    ho = stride * (-(-H // stride) - 1) + 1       # the taps' row span
    wo = stride * (-(-W // stride) - 1) + 1
    out = None
    for i in range(k):
        for j in range(k):
            patch = xp[:, :, i:i + ho:stride, j:j + wo:stride]
            for c in range(C):
                term = patch[..., c, None] * w[None, :, None, None, i, j, c]
                out = term if out is None else out + term
    return out


def make_adapt_fns(dep: Deployment, *, capacity: int, chunk_slots: int,
                   adapt: AdaptConfig, fold_mode: str | None = None,
                   device: str | torch.device | None = None,
                   registry: bool = False,
                   executor: LaneExecutor | None = None) -> AdaptFns:
    """Build the per-lane-adapting fold/readout for ``dep`` on ``device``.

    The serving forward keeps the frozen engine's semantics (masking, state
    update) with each lane under its own ``quantize(w_q + dw)`` /
    ``theta + dtheta`` numerics. ``registry=True`` builds the multi-variant
    flavour: fold/readout take ``(entry, bundle)`` and each lane's base
    numerics come from its entry before its deltas apply. ``fold_mode``
    must stay ``None``: the kernel fold modes cannot adapt. A sharded
    ``executor`` splits the lane axis as ``accumulator.make_stream_fns``
    does: each lane's deltas and traces live on its shard's device.
    """
    if fold_mode is not None:
        raise ValueError(
            f"online adaptation runs its own differentiable per-lane fold: "
            f"fold_mode={fold_mode!r} asks for a streaming-fold kernel, "
            f"which shares one weight tensor across lanes and has no "
            f"backward — leave fold_mode=None, or drop adapt")
    if executor is not None and executor.is_sharded:
        extra = (AXIS, REP) if registry else ()
        return shard_lane_fns(
            executor, capacity, resolve_device(device),
            lambda cap, place: make_adapt_fns(
                dep, capacity=cap, chunk_slots=chunk_slots, adapt=adapt,
                device=place, registry=registry),
            {"init_state": (), "init_adapt": (),
             "fold": (AXIS,) * 4 + extra, "readout": (AXIS,) * 5 + extra})
    base = (make_multi_stream_fns if registry else make_stream_fns)(
        dep, capacity=capacity, chunk_slots=chunk_slots, device=device)
    dev = base.device
    p2m_cfg, bb_cfg = dep.model_cfg.p2m, dep.model_cfg.backbone
    analog_cfg = p2m_cfg.analog
    stride, dv_unit = p2m_cfg.stride, analog_cfg.dv_unit
    H, W = bb_cfg.input_hw
    k, cin, Fo = (p2m_cfg.kernel_size, p2m_cfg.in_channels,
                  p2m_cfg.out_channels)
    nb0 = adapt_entry_numerics(dep, dev)

    def lane_mask(m: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(m, bool), device=dev)

    def init_adapt() -> dict:
        return {
            "dw": torch.zeros((capacity, k, k, cin, Fo), device=dev),
            "dtheta": torch.zeros((capacity,), device=dev),
            "elig_w": torch.zeros((capacity, k, k, cin, Fo), device=dev),
            "elig_theta": torch.zeros((capacity,), device=dev),
            "ev": torch.zeros((capacity, Fo, H, W, cin), device=dev),
            "n_updates": torch.zeros((capacity,), dtype=torch.int32,
                                     device=dev),
        }

    def reset_lane_transient(astate: dict, lane: int) -> dict:
        """New stream on the lane: clear the event accumulator and the
        eligibility traces in place, keep the learned deltas."""
        for key in _TRANSIENT:
            astate[key][lane] = 0
        return astate

    def reset_lane_full(astate: dict, lane: int) -> dict:
        """The lane rebinds to another entry uid: deltas learned against
        the old base mean nothing there — zero everything in place."""
        for v in astate.values():
            v[lane] = 0
        return astate

    def lane_bases(extra: tuple) -> list[dict]:
        """Each lane's base numerics: its entry's (registry) or ``dep``'s."""
        if not registry:
            return [nb0] * capacity
        entry, bundle = extra
        entry = np.asarray(entry)
        per = {int(e): take_entry(bundle, int(e)) for e in np.unique(entry)}
        return [per[int(e)] for e in entry]

    def lane_relin(nb: dict, dw: torch.Tensor, dtheta: torch.Tensor) -> dict:
        """One lane's adapted numerics through the differentiable seam."""
        return relinearized_numerics(
            nb["w_q"] + dw, nb["theta"] + dtheta, analog_cfg=analog_cfg,
            coeffs=nb["coeffs"], n_sub=p2m_cfg.n_sub, dt_ms=p2m_cfg.dt_ms)

    def relin_lanes(nbs: list[dict], dw: torch.Tensor, dtheta: torch.Tensor
                    ) -> dict:
        """Every lane's numerics, stacked on the lane axis. One call per
        lane, at the shapes of the frozen ``entry_numerics``, so a lane
        with zero deltas gets the frozen engine's values bit for bit."""
        per = [lane_relin(nb, dw[i], dtheta[i]) for i, nb in enumerate(nbs)]
        return {key: torch.stack([p[key] for p in per])
                for key in ("w_q", "a", "drift", "theta")}

    def lane_pv(nbs: list[dict]) -> dict:
        if not registry:
            return nb0["pv"]
        return {key: torch.stack([nb["pv"][key] for nb in nbs])[:, None, None]
                for key in ("gain", "offset")}

    @torch.no_grad()
    def fold(state: dict, astate: dict, frames: torch.Tensor,
             active: np.ndarray, *extra) -> tuple[dict, dict]:
        """One replay chunk under per-lane numerics, with the per-filter
        event accumulator ``E`` riding the same decay. The deposits are each
        lane's conv under its own weights (:func:`lane_conv`): with integer
        event counts and weights on the quantizer's level grid every product
        and partial sum is exact, so they are the shared-weight conv's bits
        (``_conv``) in any order of summation."""
        act = lane_mask(active)
        ln = relin_lanes(lane_bases(extra), astate["dw"], astate["dtheta"])
        frames = frames.to(dev)
        a = ln["a"]
        dep_s = lane_conv(frames.transpose(0, 1), ln["w_q"], stride) * dv_unit
        x, E = state["x"], astate["ev"]
        for s in range(frames.shape[1]):
            x = x * a[:, None, None, :] + dep_s[s]
            E = E * a[:, :, None, None, None] + frames[:, s, None]
        return ({**state, "x": _mask(act, x, state["x"])},
                {**astate, "ev": _mask(act, E, astate["ev"])})

    def lane_grads(nbs: list[dict], astate: dict, state: dict,
                   lanes: np.ndarray, target: torch.Tensor, extra: tuple
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-lane ``(g_w, g_theta)`` of the window cross-entropy against
        ``target`` for the lanes ``lanes``, with the linear charge
        recomputed from the event accumulator under the current deltas:
        the truncated depth-1 window through the curve-fit seam (the decay
        weighting inside ``E`` and the earlier windows' coarse counts are
        constants). ``x_lin[h, w, f] = conv(E[f], w_q[..., f])`` is the
        diagonal of the reference's full ``conv(E, w_q)``, computed as
        :func:`lane_conv` over (lane, filter) pairs, which forms only the
        diagonal."""
        idx = torch.as_tensor(lanes, device=dev)
        L = len(lanes)
        with torch.enable_grad():
            dw = astate["dw"][idx].clone().requires_grad_(True)
            dth = astate["dtheta"][idx].clone().requires_grad_(True)
            sub = [nbs[int(i)] for i in lanes]
            ln = relin_lanes(sub, dw, dth)
            E = astate["ev"][idx]                        # [L, F, H, W, cin]
            w_d = ln["w_q"].permute(0, 4, 1, 2, 3).reshape(L * Fo, k, k,
                                                           cin, 1)
            y = lane_conv(E.reshape((1, L * Fo) + E.shape[2:]), w_d, stride)
            x_lin = y.reshape(L, Fo, y.shape[2], y.shape[3]).permute(
                0, 2, 3, 1) * dv_unit
            pv = lane_pv(sub)
            ro = _layer1_readout(x_lin, state["coarse"][idx],
                                 ln["drift"][:, None, None, :],
                                 ln["theta"][:, None, None, None], pv,
                                 analog_cfg)
            logits_t, _ = backbone_lanes(
                lambda j: sub[j], {key: v[idx] for key, v in
                                   state["mem"].items()},
                ro["coarse"], np.arange(L), bb_cfg)
            logp = torch.log_softmax(logits_t, dim=-1)
            loss = -logp[torch.arange(L, device=dev), target[idx]].sum()
            g_w, g_th = torch.autograd.grad(loss, (dw, dth))
        return g_w, g_th

    @torch.no_grad()
    def readout(state: dict, astate: dict, active: np.ndarray,
                coarse_mask: np.ndarray, labels: np.ndarray, *extra
                ) -> tuple[dict, dict, dict]:
        """The frozen readout under per-lane numerics, then one local update
        on the lanes crossing a labeled coarse boundary (``labels`` [capacity]
        host ints, -1 for an unlabeled stream)."""
        act, cm = lane_mask(active), lane_mask(coarse_mask)
        step = bool(np.any(coarse_mask))
        nbs = lane_bases(extra)
        ln = relin_lanes(nbs, astate["dw"], astate["dtheta"])
        ro = _layer1_readout(state["x"], state["coarse"],
                             ln["drift"][:, None, None, :],
                             ln["theta"][:, None, None, None], lane_pv(nbs),
                             analog_cfg)
        if step:
            # the lanes at a coarse boundary, each under its own entry's
            # backbone (the frozen readouts' backbone_lanes)
            ro["logits_t"], ro["mem2"] = backbone_lanes(
                lambda i: nbs[i], state["mem"], ro["coarse"],
                np.flatnonzero(coarse_mask), bb_cfg)
        new_state, out = _commit_readout(state, ro, act, cm, step)

        # ---- local update (per lane; no lane reads another) ----
        lab = np.asarray(labels)
        has_label = lab >= 0
        boundary = np.asarray(active, bool) & np.asarray(coarse_mask, bool)
        upd = boundary & has_label
        if adapt.rule == "surrogate":
            tgt = torch.as_tensor(np.maximum(lab, 0), dtype=torch.long,
                                  device=dev)
            need = upd
        else:
            # three-factor: the eligibility trace accumulates the gradient
            # toward the lane's own prediction; the reward gates it in
            tgt = (torch.argmax(ro["logits_t"], dim=-1) if step else
                   torch.zeros((capacity,), dtype=torch.long, device=dev))
            need = boundary
        g_w = torch.zeros_like(astate["dw"])
        g_th = torch.zeros_like(astate["dtheta"])
        # one lane a pass (see the module docstring): a sharded serve
        # learns the deltas of an unsharded one
        for lane in np.flatnonzero(need):
            gw, gt = lane_grads(nbs, astate, state, np.array([lane]), tgt,
                                extra)
            g_w[lane], g_th[lane] = gw[0], gt[0]
        if adapt.rule == "surrogate":
            dw_step, th_step = adapt.lr_w * g_w, adapt.lr_theta * g_th
            elig_w, elig_th = astate["elig_w"], astate["elig_theta"]
        else:
            bnd = lane_mask(boundary)
            elig_w = _mask(bnd, adapt.trace_decay * astate["elig_w"] + g_w,
                           astate["elig_w"])
            elig_th = torch.where(bnd, adapt.trace_decay
                                  * astate["elig_theta"] + g_th,
                                  astate["elig_theta"])
            r = torch.as_tensor(np.where(
                has_label, np.where(tgt.cpu().numpy() == lab, 1.0, -1.0),
                0.0), dtype=torch.float32, device=dev)
            dw_step = adapt.lr_w * r[:, None, None, None, None] * elig_w
            th_step = adapt.lr_theta * r * elig_th
        dw = torch.clamp(astate["dw"] - dw_step, -adapt.clip_w, adapt.clip_w)
        dth = torch.clamp(astate["dtheta"] - th_step, -adapt.clip_theta,
                          adapt.clip_theta)
        u = lane_mask(upd)
        new_astate = {
            "dw": _mask(u, dw, astate["dw"]),
            "dtheta": torch.where(u, dth, astate["dtheta"]),
            "elig_w": elig_w,
            "elig_theta": elig_th,
            # the event accumulator precharges with the capacitor
            "ev": _mask(act, torch.zeros_like(astate["ev"]), astate["ev"]),
            "n_updates": astate["n_updates"] + u.to(torch.int32),
        }
        return new_state, new_astate, out

    return AdaptFns(init_state=base.init_state, init_adapt=init_adapt,
                    reset_lane=base.reset_lane,
                    reset_lane_transient=reset_lane_transient,
                    reset_lane_full=reset_lane_full, fold=fold,
                    readout=readout, in_hw=base.in_hw,
                    n_classes=base.n_classes, device=dev)


def lane_stats(astate: dict) -> list[dict]:
    """Host-side per-lane rows for the v5 stats artifact: the lanes that
    applied at least one update, with their delta norms."""
    dw = astate["dw"].cpu().numpy()
    dth = astate["dtheta"].cpu().numpy()
    n_upd = astate["n_updates"].cpu().numpy()
    rows = []
    for lane in range(n_upd.shape[0]):
        if int(n_upd[lane]) == 0:
            continue
        rows.append({
            "lane": lane,
            "n_updates": int(n_upd[lane]),
            "dw_norm": float(np.linalg.norm(dw[lane])),
            "dtheta": float(dth[lane]),
        })
    return rows
