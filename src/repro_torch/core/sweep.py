"""Batched co-design sweep engine (paper Fig 2 / Fig 4 / Table 1) — the
PyTorch port of ``repro.core.sweep``.

The paper's central result is the trade-off across the three analog MAC
circuit configs (basic / isolation-switch / nullified) and the
integration time T_INTG. This module evaluates the full grid

    circuit-variant × T_INTG (× n_sub)

in one process. The variant axis comes from the registry in
``core/variant_grid.py`` (``circuit``, ``null_mismatch``, ``v_threshold``,
``sigma``): it expands into a flat list of variants whose params, BN
state and optimizer state are stacked on a leading ``[n_cfg]`` axis.
Within one outer (T_INTG, n_sub) cell every step runs each variant in
turn (:func:`_map_cfgs`, the reference's ``lax.map``). T_INTG and
``n_sub`` change tensor shapes, so they stay in the outer Python loop.

Protocol per grid point (paper §3):
  phase 1  pretrain the whole net once at the longest T_INTG with an
           ideal (no-leak) layer 1, shared by every grid point;
  phase 2  per outer cell: constrain layer 1 under every variant,
           finetune each variant's backbone, then evaluate accuracy,
           bandwidth and energy; retention-error surfaces come from the
           closed-form leak ODE.

Phase 2 comes in two protocols:

  ``protocol="frozen"``    the paper's protocol: layer 1 is frozen and
                           only the n_cfg backbones train; the ideal conv
                           of the curve-fit forward runs once per step,
                           outside autograd, and each variant reduces it;
  ``protocol="unfrozen"``  each variant also learns its own layer-1
                           weights through the differentiable curve-fit
                           forward, re-linearizing its leak from its
                           current weights every step, with layer 1 at
                           its own LR (``SweepConfig.lr_p2m``) through
                           :func:`joint_optimizer`.

Training runs through the curve-fit forward only (the reference refuses
any other mode), so a sweep launches no hand-written kernel.
``run_protocols`` runs both protocols off one shared pretrain and
``protocols_artifact`` merges them into one ``p2m-codesign-sweep/v3``
artifact (docs/sweep.md). Batches are drawn on the CPU from one
``torch.Generator`` in the reference's order (pretrain batches, then per
cell one warm-up batch, ``finetune_steps`` batches and ``eval_batches``
batches) and moved to the run's device.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import analog as analog_mod
from repro_torch.core import energy as energy_mod
from repro_torch.core import leakage, p2m_layer, snn, variant_grid
from repro_torch.core.leakage import CircuitConfig, LeakageConfig
from repro_torch.core.sweep_exec import AXIS, REP, SweepExecutor
from repro_torch.data import sources as sources_mod
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim import adamw, clip_by_global_norm
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.utils import tree_leaves, tree_map, tree_paths, unflatten_dict

Params = dict

SCHEMA_V3 = "p2m-codesign-sweep/v3"
PROTOCOLS = ("frozen", "unfrozen")
RETENTION_V0 = 0.2     # probe swing (V) for the Fig 4a retention surfaces


def resolve_protocols(arg: str) -> tuple[str, ...]:
    """CLI protocol argument → protocol tuple ("both" expands to all)."""
    return PROTOCOLS if arg == "both" else (arg,)


def _check_protocol(protocol: str) -> None:
    if protocol not in PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r} "
                         f"(expected one of {PROTOCOLS})")


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepGrid:
    """The co-design grid: circuits × every registered variant axis. An
    empty value tuple means the axis is not swept; the axes' semantics
    live in ``core/variant_grid.py``."""
    circuits: tuple[CircuitConfig, ...] = (
        CircuitConfig.BASIC, CircuitConfig.SWITCH, CircuitConfig.NULLIFIED)
    t_intg_grid_ms: tuple[float, ...] = (1.0, 10.0, 100.0, 1000.0)
    null_mismatch: tuple[float, ...] = (0.06,)
    v_threshold: tuple[float, ...] = ()
    sigma: tuple[float, ...] = ()
    n_sub: tuple[int, ...] = ()


def paper_grid() -> SweepGrid:
    """All three circuits × the paper's T_INTG grid."""
    return SweepGrid()


def fast_grid() -> SweepGrid:
    return SweepGrid(t_intg_grid_ms=(10.0, 1000.0))


def expand_leak_configs(grid: SweepGrid, base: LeakageConfig
                        ) -> tuple[LeakageConfig, ...]:
    """Flatten (circuits × active stacked axes) into the variant list."""
    return variant_grid.expand_variants(grid, base)


def config_label(lc: LeakageConfig) -> str:
    return variant_grid.variant_label(lc)


# ---------------------------------------------------------------------------
# the variant loop and the layer-1 plumbing
# ---------------------------------------------------------------------------

def _take(x: Any, i: int) -> Any:
    """Variant ``i`` of a stacked argument: a list holds one item per
    variant, a tree of tensors a leading [n_cfg] axis."""
    return x[i] if isinstance(x, list) else tree_map(lambda v: v[i], x)


def _map_cfgs(fn: Callable, *stacked):
    """Run ``fn`` once per variant, in order, and stack each output leaf on
    a leading [n_cfg] axis. Every argument is a list with one item per
    variant or a tree of tensors stacked on a leading [n_cfg] axis.

    The reference maps the variant axis with ``lax.map`` (a sequential
    scan) rather than ``vmap``, so that every variant runs the same
    program whatever the number of variants; this is its counterpart, a
    Python loop, not ``torch.func.vmap``. A variant's autograd graph is
    freed before the next one runs, so the peak memory is one variant's."""
    first = stacked[0]
    n = (len(first) if isinstance(first, list)
         else tree_leaves(first)[0].shape[0])
    outs = [fn(*(_take(s, i) for s in stacked)) for i in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])


def _pool_coarsen_l1(spikes: torch.Tensor, events: torch.Tensor, model_cfg
                     ) -> tuple[torch.Tensor, dict]:
    """Shared tail of the single-config layer-1 paths: 2x pool, coarsen to
    the backbone grid, and the spike/MAC bookkeeping. ``macs/p2m`` is a
    float32 scalar and ``spikes/p2m`` a float32 sum, as the reference's:
    above 2^24 both round, and the sum depends on its order, on either
    side."""
    cfg = model_cfg.p2m
    B, T = spikes.shape[:2]
    tb = snn.max_pool(spikes.reshape((B * T,) + spikes.shape[2:]))
    spikes_p = tb.reshape((B, T) + tb.shape[1:])
    coarse = p2m_layer.coarsen_spikes(spikes_p, model_cfg.coarsen_group())
    k = cfg.kernel_size
    out_elems = float(B * T) * float(math.prod(spikes_p.shape[2:]))
    l1 = {
        "spikes/p2m": torch.sum(spikes_p).detach(),
        "events/in": torch.sum(events).detach(),
        "macs/p2m": torch.tensor(out_elems * k * k * cfg.in_channels,
                                 dtype=torch.float32, device=events.device),
    }
    return coarse, l1


def _layer1_coarse_one(p2m_params: Params, events: torch.Tensor, model_cfg,
                       coeffs: leakage.LeakCoeffs
                       ) -> tuple[torch.Tensor, dict]:
    """Single-variant differentiable P²M layer → pool → coarsen; the leak
    is re-linearized from the current quantized weights on every call."""
    spikes, _ = p2m_layer.p2m_forward_curvefit_coeffs(p2m_params, events,
                                                      model_cfg.p2m, coeffs)
    return _pool_coarsen_l1(spikes, events, model_cfg)


def _layer1_coarse(p2m_params: Params, events: torch.Tensor, model_cfg,
                   leak_cfgs: tuple[LeakageConfig, ...]
                   ) -> tuple[torch.Tensor, dict]:
    """P²M layer under every circuit config (in ``cfg.p2m.mode``) + pool +
    coarsen: events [B, T, n_sub, H, W, Cin] → coarse [n_cfg, B, Tc, H/2,
    W/2, F] plus per-config ``spikes/p2m`` [G] and the scalar
    ``events/in`` and ``macs/p2m``. The physics validator's path; the
    engine's steps use :func:`_layer1_coarse_one` and
    :func:`_layer1_coarse_frozen`."""
    spikes, _ = p2m_layer.p2m_apply_stacked(p2m_params, events,
                                            model_cfg.p2m, leak_cfgs)
    coarse, l1_s = _map_cfgs(
        lambda s: _pool_coarsen_l1(s, events, model_cfg), spikes)
    return coarse, _merge_grouped_l1(l1_s)


def _layer1_coarse_frozen(p2m_params: Params, events: torch.Tensor,
                          model_cfg, coeffs: list[leakage.LeakCoeffs]
                          ) -> tuple[torch.Tensor, dict]:
    """Frozen-protocol stacked layer 1: the ideal conv once, then per
    variant only the leak linearization, the decay reduction, the
    transfer curve, the comparator and the pooling. Without autograd (the
    reference's ``stop_gradient``: frozen layer 1 is not differentiated).
    Returns (coarse [n_cfg, ...], l1 stats stacked [n_cfg])."""
    cfg = model_cfg.p2m
    with torch.no_grad():
        w_q = p2m_layer.effective_weights(p2m_params, cfg)
        ideal = p2m_layer.curvefit_ideal(events, cfg, w_q)

        def per_cfg(co):
            lk = leakage.leak_params_from_coeffs(w_q, co)
            v_pre = p2m_layer.curvefit_reduce(p2m_params, cfg, ideal, lk,
                                              events.shape[0])
            spikes = snn.spike_fn(v_pre - co.v_threshold)
            del v_pre
            return _pool_coarsen_l1(spikes, events, model_cfg)

        return _map_cfgs(per_cfg, coeffs)


def _merge_grouped_l1(l1_s: dict) -> dict:
    """Per-variant l1 stats → per-config spikes [G], config-independent
    events/MACs as scalars."""
    return {"spikes/p2m": l1_s["spikes/p2m"],
            "events/in": l1_s["events/in"][0],
            "macs/p2m": l1_s["macs/p2m"][0]}


def joint_optimizer(opt_backbone: Optimizer, opt_p2m: Optimizer) -> Optimizer:
    """Per-group optimizer for the unfrozen joint update: the layer-1
    group steps with ``opt_p2m`` (``SweepConfig.lr_p2m``), the backbone
    with ``opt_backbone``; each group keeps its own state."""
    def init(params: Params) -> Params:
        return {"p2m": opt_p2m.init(params["p2m"]),
                "backbone": opt_backbone.init(params["backbone"])}

    def update(grads, state, params):
        up_p, st_p = opt_p2m.update(grads["p2m"], state["p2m"],
                                    params["p2m"])
        up_b, st_b = opt_backbone.update(grads["backbone"],
                                         state["backbone"],
                                         params["backbone"])
        return ({"p2m": up_p, "backbone": up_b},
                {"p2m": st_p, "backbone": st_b})

    return Optimizer(init=init, update=update)


def _check_curvefit(model_cfg, protocol: str) -> None:
    if model_cfg.p2m.mode != "curvefit":
        raise ValueError(
            f"the batched {protocol} step trains through the curvefit "
            f"forward; got p2m.mode={model_cfg.p2m.mode!r}. Use "
            f"p2m_apply_stacked for scan/kernel physics validation.")


def _value_and_grad(loss_fn: Callable, tree: Params):
    """``loss_fn(tree) → (loss, extra)`` and the gradient of the loss with
    respect to every leaf of ``tree`` (a tree of the same layout)."""
    diff = {path: t.detach().requires_grad_(True)
            for path, t in tree_paths(tree)}
    with torch.enable_grad():
        loss, extra = loss_fn(unflatten_dict(diff))
        got = torch.autograd.grad(loss, list(diff.values()))
    return loss.detach(), extra, unflatten_dict(dict(zip(diff, got)))


def _coeffs(model_cfg, leak_cfgs) -> list[leakage.LeakCoeffs]:
    return [leakage.leak_coeffs(lc, model_cfg.p2m.v_threshold)
            for lc in leak_cfgs]


def _sharded(ex: SweepExecutor, dev: torch.device, make_body: Callable,
             in_specs: tuple[str, ...]) -> Callable:
    """``make_body(place)`` for each of the executor's shards, mapped over
    the variant axis (the one body on ``dev`` when unsharded)."""
    places = ex.bind(dev)
    return ex.shard([make_body(p) for p in places], in_specs, places)


def _finetune_body(model_cfg, opt: Optimizer, protocol: str,
                   dev: torch.device) -> Callable:
    """One shard's phase-2 step on ``dev``: ``inner(coeffs, p2m, bb_s,
    opt_s, state_s, events, labels)`` over the variants of ``coeffs``."""
    bb_cfg = model_cfg.backbone

    def to_dev(events, labels):
        return (torch.as_tensor(events, dtype=torch.float32, device=dev),
                torch.as_tensor(labels, device=dev).long())

    def update(grads, o_s, params):
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        updates, o_s = opt.update(grads, o_s, params)
        return apply_updates(params, updates), o_s, gnorm

    if protocol == "frozen":
        def inner(coeffs, p2m_params, bb_params_s, opt_state_s, state_s,
                  events, labels):
            events, labels = to_dev(events, labels)
            coarse_s, l1_s = _layer1_coarse_frozen(p2m_params, events,
                                                   model_cfg, coeffs)

            def per_cfg(bb_p, o_s, st, coarse):
                def loss_fn(p):
                    logits, new_st, _ = snn.spiking_cnn_apply(
                        p, st, coarse, bb_cfg, train=True)
                    return snn.cross_entropy(logits, labels), (new_st, logits)

                loss, (new_st, logits), grads = _value_and_grad(loss_fn, bb_p)
                bb_p, o_s, gnorm = update(grads, o_s, bb_p)
                return bb_p, o_s, new_st, {
                    "loss": loss, "gnorm": gnorm,
                    "acc": snn.accuracy(logits.detach(), labels)}

            bb_params_s, opt_state_s, state_s, metrics = _map_cfgs(
                per_cfg, bb_params_s, opt_state_s, state_s, coarse_s)
            return (p2m_params, bb_params_s, opt_state_s, state_s, metrics,
                    l1_s)

        return inner

    def inner(coeffs, p2m_params_s, bb_params_s, opt_state_s, state_s,
              events, labels):
        events, labels = to_dev(events, labels)

        def per_cfg(p2m_p, bb_p, o_s, st, co):
            def loss_fn(joint):
                coarse, l1 = _layer1_coarse_one(joint["p2m"], events,
                                                model_cfg, co)
                logits, new_st, _ = snn.spiking_cnn_apply(
                    joint["backbone"], st, coarse, bb_cfg, train=True)
                return (snn.cross_entropy(logits, labels),
                        (new_st, logits, l1))

            loss, (new_st, logits, l1), grads = _value_and_grad(
                loss_fn, {"p2m": p2m_p, "backbone": bb_p})
            joint, o_s, gnorm = update(grads, o_s,
                                       {"p2m": p2m_p, "backbone": bb_p})
            return joint["p2m"], joint["backbone"], o_s, new_st, {
                "loss": loss, "gnorm": gnorm,
                "acc": snn.accuracy(logits.detach(), labels)}, l1

        return _map_cfgs(per_cfg, p2m_params_s, bb_params_s, opt_state_s,
                         state_s, coeffs)

    return inner


def make_batched_finetune_step(model_cfg, leak_cfgs: tuple[LeakageConfig, ...],
                               opt: Optimizer, protocol: str = "frozen",
                               device: str | torch.device | None = None,
                               executor: SweepExecutor | None = None
                               ) -> Callable:
    """One phase-2 step over all n_cfg circuit variants on ``device``
    (cuda unless the caller asks for the CPU)::

        p2m_ps, bb_params_s, opt_state_s, state_s, metrics, l1 = step(
            p2m_ps, bb_params_s, opt_state_s, state_s, events, labels)

    ``protocol="frozen"`` (paper §3): ``p2m_ps`` is the shared layer-1
    params, returned untouched; layer 1 runs once for every variant
    outside autograd and each variant's backbone takes a step: the
    backbone's gradients, clipped at global norm 1 over the backbone
    alone, then ``opt`` (backbone-only state).

    ``protocol="unfrozen"``: ``p2m_ps`` carries a leading [n_cfg] axis and
    each variant takes a joint step on ``{"p2m", "backbone"}``: gradients
    through its own curve-fit layer 1 (surrogate spike gradient,
    straight-through quantizer), the clip over the joint tree, then
    ``opt`` (a :func:`joint_optimizer`).

    Stacked arguments carry a leading [n_cfg] axis and must be on
    ``device``; events and labels are moved there. With a sharded
    ``executor`` the stacked arguments are the ``executor.split`` of trees
    padded to ``executor.padded_size(n_cfg)`` (see :func:`run_grid`) and
    come back so; each shard runs its variants on its device, with the
    events and the shared frozen layer 1 copied there. The body is the
    same with and without sharding. ``metrics`` and ``l1`` come back
    unpadded, on the first shard's device. This is not
    ``codesign.make_train_step``, whose frozen step zeroes layer 1's
    gradients inside a joint tree; it reuses its pieces."""
    _check_protocol(protocol)
    _check_curvefit(model_cfg, protocol)
    ex = executor or SweepExecutor()
    G = len(leak_cfgs)
    coeffs = ex.pad_stacked(_coeffs(model_cfg, leak_cfgs), G)
    p2m_spec = REP if protocol == "frozen" else AXIS
    run = _sharded(ex, resolve_device(device),
                   lambda d: _finetune_body(model_cfg, opt, protocol, d),
                   (AXIS, p2m_spec, AXIS, AXIS, AXIS, REP, REP))

    def step(p2m_ps, bb_params_s, opt_state_s, state_s, events, labels):
        p2m_out, bb_params_s, opt_state_s, state_s, metrics, l1_s = run(
            coeffs, p2m_ps, bb_params_s, opt_state_s, state_s, events,
            labels)
        if protocol == "frozen":
            p2m_out = p2m_ps
        metrics, l1_s = ex.gather((metrics, l1_s), G)
        return (p2m_out, bb_params_s, opt_state_s, state_s, metrics,
                _merge_grouped_l1(l1_s))

    return step


def _eval_body(model_cfg, protocol: str, dev: torch.device) -> Callable:
    """One shard's batched eval on ``dev``: ``inner(coeffs, p2m, bb_s,
    state_s, events, labels) → (metrics, aux, l1_s)``."""
    bb_cfg = model_cfg.backbone

    def head(bb_p, st, coarse, labels):
        logits, _, aux = snn.spiking_cnn_apply(bb_p, st, coarse, bb_cfg,
                                               train=False)
        return {"acc": snn.accuracy(logits, labels),
                "loss": snn.cross_entropy(logits, labels)}, aux

    def inner(coeffs, p2m_ps, bb_params_s, state_s, events, labels):
        events = torch.as_tensor(events, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev).long()
        with torch.no_grad():
            if protocol == "frozen":
                coarse_s, l1_s = _layer1_coarse_frozen(p2m_ps, events,
                                                       model_cfg, coeffs)

                def per_cfg(bb_p, st, coarse, l1):
                    return (*head(bb_p, st, coarse, labels), l1)

                return _map_cfgs(per_cfg, bb_params_s, state_s, coarse_s,
                                 l1_s)

            def per_cfg(p2m_p, bb_p, st, co):
                coarse, l1 = _layer1_coarse_one(p2m_p, events, model_cfg, co)
                return (*head(bb_p, st, coarse, labels), l1)

            return _map_cfgs(per_cfg, p2m_ps, bb_params_s, state_s, coeffs)

    return inner


def make_batched_eval(model_cfg, leak_cfgs: tuple[LeakageConfig, ...],
                      protocol: str = "frozen",
                      device: str | torch.device | None = None,
                      executor: SweepExecutor | None = None) -> Callable:
    """Batched eval on ``device``: ``ev(p2m_ps, bb_params_s, state_s,
    events, labels) → (metrics {"acc", "loss"} [G], aux {key: [G]}, l1)``
    with the layer-1 spike statistics feeding bandwidth and energy. Under
    ``protocol="unfrozen"`` the first argument carries per-variant layer-1
    params and the whole forward runs per variant. A sharded ``executor``
    splits the variant axis as :func:`make_batched_finetune_step` does;
    the outputs come back unpadded."""
    _check_protocol(protocol)
    _check_curvefit(model_cfg, protocol)
    ex = executor or SweepExecutor()
    G = len(leak_cfgs)
    coeffs = ex.pad_stacked(_coeffs(model_cfg, leak_cfgs), G)
    p2m_spec = REP if protocol == "frozen" else AXIS
    run = _sharded(ex, resolve_device(device),
                   lambda d: _eval_body(model_cfg, protocol, d),
                   (AXIS, p2m_spec, AXIS, AXIS, REP, REP))

    def ev(p2m_ps, bb_params_s, state_s, events, labels):
        metrics, aux, l1_s = ex.gather(
            run(coeffs, p2m_ps, bb_params_s, state_s, events, labels), G)
        return metrics, aux, _merge_grouped_l1(l1_s)

    return ev


# ---------------------------------------------------------------------------
# phase 1 (shared pretrain)
# ---------------------------------------------------------------------------

def _to(tree: Any, dev: torch.device) -> Any:
    return tree_map(lambda t: t.to(dev), tree)


def _fork(gen: torch.Generator) -> torch.Generator:
    """A generator at ``gen``'s state, so a protocol's draws leave the
    shared post-pretrain state as it was (the reference reuses its key)."""
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


def pretrain_backbone(gen: torch.Generator, data_cfg, model_cfg, sweep,
                      log: Any = print,
                      device: str | torch.device | None = None
                      ) -> tuple[Params, dict, torch.Generator]:
    """Phase-1 pretrain at the longest T_INTG with an ideal (no-leak)
    circuit, shared by every grid point, on ``device``. Draws the init and
    then one batch per step from ``gen``; returns (params, BN state,
    ``gen``) as the reference returns its key."""
    from repro_torch.core import codesign

    dev = resolve_device(device)
    source = sources_mod.as_source(data_cfg)
    t_long = max(sweep.t_intg_grid_ms)
    pre_cfg = replace(
        model_cfg,
        p2m=replace(model_cfg.p2m, t_intg_ms=t_long, mode="curvefit",
                    leak=replace(model_cfg.p2m.leak,
                                 circuit=CircuitConfig.IDEAL)))
    params, state = codesign.model_init(gen, pre_cfg)
    params, state = _to(params, dev), _to(state, dev)
    opt = adamw(sweep.lr)
    opt_state = opt.init(params)
    step_fn = codesign.make_train_step(pre_cfg, opt, freeze_p2m=False,
                                       device=dev)
    for i in range(sweep.pretrain_steps):
        ev, labels = source.sample_batch(gen, sweep.batch_size, t_long,
                                         n_sub=pre_cfg.p2m.n_sub)
        params, opt_state, state, m, _ = step_fn(params, opt_state, state,
                                                 ev, labels)
        if i % 10 == 0:
            log(f"[pretrain] step {i} loss={float(m['loss']):.3f} "
                f"acc={float(m['acc']):.3f}")
    return params, state, gen


# ---------------------------------------------------------------------------
# the grid run
# ---------------------------------------------------------------------------

@dataclass
class GridResult:
    """Everything one sweep produced: flat records (one per (variant,
    T_INTG, n_sub) cell), the retention surface and grid meta.

    ``final_params`` (``run_grid(keep_params=True)``) holds each outer
    cell's trained weights keyed by ``(t_intg_ms, n_sub)``: ``{"p2m",
    "backbone", "state"}`` with backbone and state stacked on the
    ``[n_cfg]`` variant axis (p2m too under the unfrozen protocol, shared
    when frozen), the seam ``stream.deploy.deploy_from_sweep`` slices one
    variant's checkpoint out of. ``timings`` holds each cell's host-clock
    seconds (``train_s``, ``train_sample_s``: the share of it spent in
    ``sample_batch``, ``eval_s``, ``eval_sample_s``) and on cuda its
    ``peak_bytes`` of device memory. Neither is part of the artifact."""
    records: list[dict]
    retention: dict
    labels: tuple[str, ...]
    grid: SweepGrid
    protocol: str = "frozen"
    final_params: dict[tuple[float, int], dict] = field(default_factory=dict)
    timings: dict[tuple[float, int], dict] = field(default_factory=dict)

    def to_artifact(self, extra_meta: dict | None = None) -> dict:
        return {
            "schema": SCHEMA_V3,
            "protocol": self.protocol,
            "grid": {
                "circuits": [c.value for c in self.grid.circuits],
                "t_intg_grid_ms": list(self.grid.t_intg_grid_ms),
                "null_mismatch": list(self.grid.null_mismatch),
                "labels": list(self.labels),
                "axes": variant_grid.active_axes(self.grid),
                "axis_values": variant_grid.grid_axis_values(self.grid),
            },
            "retention": self.retention,
            "records": self.records,
            **(extra_meta or {}),
        }


def _normalize(records: list[dict]) -> None:
    """Per (config label, n_sub) series, normalize bandwidth and per-step
    train time to the longest-T point and compute the energy improvement
    against that series' single conventional reference (paper Fig 2
    right: the digital backend integrates at the long T)."""
    by_series: dict[tuple, list[dict]] = {}
    for r in records:
        by_series.setdefault((r["label"], r["n_sub"]), []).append(r)
    for rs in by_series.values():
        base = max(rs, key=lambda r: r["t_intg_ms"])
        e_conv_ref = base["backend_energy_conventional_j"]
        for r in rs:
            r["bandwidth_norm"] = (r["bandwidth_ratio"] /
                                   max(base["bandwidth_ratio"], 1e-12))
            r["train_time_norm"] = (r["train_time_per_step_s"] /
                                    max(base["train_time_per_step_s"], 1e-12))
            r["energy_improvement"] = e_conv_ref / max(
                r["backend_energy_p2m_j"], 1e-30)


def _timed_batch(source, gen, sweep, t_ms: float, ns: int, clock: list):
    """``source.sample_batch`` with its host seconds added to ``clock[0]``."""
    t0 = time.perf_counter()
    out = source.sample_batch(gen, sweep.batch_size, t_ms, n_sub=ns)
    clock[0] += time.perf_counter() - t0
    return out


def run_grid(data_cfg, model_cfg, sweep, grid: SweepGrid, log: Any = print,
             *, protocol: str = "frozen", pretrained: tuple | None = None,
             executor: SweepExecutor | None = None,
             eval_data=None, keep_params: bool = False,
             device: str | torch.device | None = None) -> GridResult:
    """Run the batched co-design sweep on ``device`` (cuda unless the
    caller asks for the CPU). ``data_cfg`` is an event source (a bare
    ``EventStreamConfig`` is wrapped), ``model_cfg`` a
    ``codesign.P2MModelConfig``, ``sweep`` a ``codesign.SweepConfig`` (its
    ``t_intg_grid_ms`` is superseded by ``grid.t_intg_grid_ms``).

    ``protocol`` selects phase 2 (``"frozen"`` or ``"unfrozen"``).
    ``pretrained`` injects a shared ``(params, state, generator)`` phase-1
    result (see :func:`run_protocols`); the generator is copied, so the
    caller's stays at the post-pretrain state. ``executor`` shards the
    stacked variant axis (``SweepExecutor(devices=n)``,
    ``core/sweep_exec.py``): the stacked trees pad to a multiple of n and
    each shard trains and evaluates its variants on its device; records,
    retention and ``final_params`` are unpadded and equal to the
    one-device run's. ``eval_data`` draws the accuracy-eval batches from
    another source. ``keep_params=True`` keeps each cell's trained
    weights on ``GridResult.final_params``.

    Records hold Python numbers: each eval batch's per-variant tensors go
    to the host in one transfer. ``train_time_s`` is host-clock time of
    the ``finetune_steps`` steps after one warm-up step, synchronised
    before and after, with the batch draws inside the window as in the
    reference."""
    _check_protocol(protocol)
    dev = resolve_device(device)
    ex = executor or SweepExecutor()
    places = ex.bind(dev)
    source = sources_mod.as_source(data_cfg)
    eval_source = (sources_mod.as_source(eval_data)
                   if eval_data is not None else source)
    leak_cfgs = expand_leak_configs(grid, model_cfg.p2m.leak)
    labels = tuple(config_label(lc) for lc in leak_cfgs)
    G = len(leak_cfgs)
    G_pad = ex.padded_size(G)
    cuda_places = [p for p in dict.fromkeys(places) if p.type == "cuda"]
    t_grid = grid.t_intg_grid_ms
    cells = variant_grid.outer_cells(grid, model_cfg.p2m.n_sub)

    sweep = replace(sweep, t_intg_grid_ms=t_grid)
    if pretrained is None:
        gen = torch.Generator().manual_seed(sweep.seed)
        pre_params, pre_state, gen = pretrain_backbone(
            gen, source, model_cfg, sweep, log, device=dev)
    else:
        pre_params, pre_state, gen = pretrained
        pre_params, pre_state = _to(pre_params, dev), _to(pre_state, dev)
        gen = _fork(gen)

    # retention surface from the closed-form leak ODE (Fig 4a): the
    # pretrained layer-1 kernel decides config (a)'s drift
    w_q = analog_mod.quantize_weights(pre_params["p2m"]["w"],
                                      model_cfg.p2m.analog)
    surface = leakage.retention_surface(w_q, leak_cfgs, t_grid,
                                        v0=RETENTION_V0).tolist()  # [G, n_t]
    retention = {
        "t_grid_ms": list(t_grid),
        "v0": RETENTION_V0,
        "mean_abs_error_v": dict(zip(labels, surface)),
    }

    opt = adamw(sweep.lr)
    lr_p2m = getattr(sweep, "lr_p2m", None)
    opt_unfrozen = joint_optimizer(
        opt, adamw(sweep.lr if lr_p2m is None else lr_p2m))
    records: list[dict] = []
    final_params: dict[tuple[float, int], dict] = {}
    timings: dict[tuple[float, int], dict] = {}
    for t_ms, ns in cells:
        for p in cuda_places:
            torch.cuda.reset_peak_memory_stats(p)
        ti = t_grid.index(t_ms)
        cfg_t = replace(
            model_cfg,
            p2m=replace(model_cfg.p2m, t_intg_ms=t_ms, n_sub=ns,
                        mode="curvefit"))
        # G_pad rows: a sharded run's padding rows train real copies of the
        # last variant, dropped on read-back
        if protocol == "unfrozen":
            # every variant starts from the shared pretrain and learns its
            # own layer-1 copy, jointly with its backbone
            p2m_ps = p2m_layer.stack_p2m_params(pre_params["p2m"], G_pad)
            bb_params_s = p2m_layer.stack_p2m_params(pre_params["backbone"],
                                                     G_pad)
            opt_state_s = _map_cfgs(opt_unfrozen.init,
                                    {"p2m": p2m_ps, "backbone": bb_params_s})
            p2m_ps = ex.split(p2m_ps, places)
            opt_t = opt_unfrozen
        else:
            p2m_ps = {k: v.clone() for k, v in pre_params["p2m"].items()}
            bb_params_s = p2m_layer.stack_p2m_params(pre_params["backbone"],
                                                     G_pad)
            opt_state_s = _map_cfgs(opt.init, bb_params_s)
            opt_t = opt
        bb_params_s, opt_state_s, state_s = ex.split(
            (bb_params_s, opt_state_s,
             p2m_layer.stack_p2m_params(pre_state, G_pad)), places)
        step_fn = make_batched_finetune_step(cfg_t, leak_cfgs, opt_t,
                                             protocol=protocol, device=dev,
                                             executor=ex)
        # warm-up step: first-call allocations stay out of the train time
        # (the paper's training-time column is steady-state epochs)
        ev_w, lab_w = source.sample_batch(gen, sweep.batch_size, t_ms,
                                          n_sub=ns)
        p2m_ps, bb_params_s, opt_state_s, state_s, m, _ = step_fn(
            p2m_ps, bb_params_s, opt_state_s, state_s, ev_w, lab_w)
        del ev_w, lab_w
        ex.synchronize(places)
        sample_s = [0.0]
        t0 = time.perf_counter()
        for _ in range(sweep.finetune_steps):
            ev, lab = _timed_batch(source, gen, sweep, t_ms, ns, sample_s)
            p2m_ps, bb_params_s, opt_state_s, state_s, m, _ = step_fn(
                p2m_ps, bb_params_s, opt_state_s, state_s, ev, lab)
            del ev, lab
        ex.synchronize(places)
        train_s = time.perf_counter() - t0

        if protocol == "unfrozen":
            # re-linearize each variant's leak around its learned kernel:
            # circuit (a)'s drift is a trained quantity here
            w_q_s = analog_mod.quantize_weights(ex.gather(p2m_ps["w"], G),
                                                cfg_t.p2m.analog)
            lk_s = leakage.grouped_leak_params(w_q_s, leak_cfgs)
            learned_surface = torch.stack(
                [torch.mean(leakage.retention_error(lk_s, RETENTION_V0, t),
                            dim=-1) for t in t_grid], dim=1).tolist()

        if keep_params:
            final_params[(t_ms, ns)] = {
                "p2m": (ex.gather(p2m_ps, G) if protocol == "unfrozen"
                        else p2m_ps),
                **ex.gather({"backbone": bb_params_s, "state": state_s}, G)}

        # batched eval: accuracy + spike statistics for bandwidth/energy
        eval_fn = make_batched_eval(cfg_t, leak_cfgs, protocol=protocol,
                                    device=dev, executor=ex)
        accs: list[list[float]] = [[] for _ in range(G)]
        l1_spikes = [0.0] * G
        in_events = 0.0
        macs = 0.0
        aux_sum: list[dict | None] = [None] * G
        eval_sample_s = [0.0]
        t1 = time.perf_counter()
        for _ in range(sweep.eval_batches):
            ev, lab = _timed_batch(eval_source, gen, sweep, t_ms, ns,
                                   eval_sample_s)
            metrics, aux, l1 = eval_fn(p2m_ps, bb_params_s, state_s, ev, lab)
            del ev, lab
            keys = sorted(aux)
            rows = torch.stack([metrics["acc"], l1["spikes/p2m"]]
                               + [aux[k].to(torch.float32) for k in keys])
            host = torch.cat([rows.flatten(), torch.stack(
                [l1["events/in"], l1["macs/p2m"]])]).tolist()
            in_events += host[-2]
            macs += host[-1]
            for g in range(G):
                col = host[g:rows.numel():G]
                accs[g].append(col[0])
                l1_spikes[g] += col[1]
                aux_g = dict(zip(keys, col[2:]))
                aux_sum[g] = aux_g if aux_sum[g] is None else {
                    k: aux_sum[g][k] + v for k, v in aux_g.items()}
        eval_s = time.perf_counter() - t1
        timings[(t_ms, ns)] = {"train_s": train_s,
                               "train_sample_s": sample_s[0],
                               "eval_s": eval_s,
                               "eval_sample_s": eval_sample_s[0]}
        if cuda_places:
            timings[(t_ms, ns)]["peak_bytes"] = max(
                torch.cuda.max_memory_allocated(p) for p in cuda_places)
        log(f"[sweep {protocol} t={t_ms}ms] sample_batch host "
            f"{sample_s[0]:.3f} s of train {train_s:.3f} s, "
            f"{eval_sample_s[0]:.3f} s of eval {eval_s:.3f} s")

        for g, (lc, lab_g) in enumerate(zip(leak_cfgs, labels)):
            bw = energy_mod.bandwidth_ratio(l1_spikes[g], in_events)
            e_conv = energy_mod.backend_energy_conventional(aux_sum[g], macs)
            e_p2m = energy_mod.backend_energy_p2m(aux_sum[g], l1_spikes[g],
                                                  macs)
            surf_row = (learned_surface[g] if protocol == "unfrozen"
                        else surface[g])
            rec = {
                "label": lab_g,
                "circuit": lc.circuit.value,
                "null_mismatch": lc.null_mismatch,
                "protocol": protocol,
                "t_intg_ms": t_ms,
                "n_sub": ns,
                "variant": variant_grid.variant_dict(
                    lc, v_threshold_default=model_cfg.p2m.v_threshold,
                    n_sub=ns),
                "accuracy": sum(accs[g]) / len(accs[g]),
                "train_time_s": train_s,
                "train_time_per_step_s": train_s / sweep.finetune_steps,
                "bandwidth_ratio": bw,
                "backend_energy_conventional_j": e_conv,
                "backend_energy_p2m_j": e_p2m,
                "sensor_energy_p2m_j": energy_mod.sensor_energy_p2m(macs),
                "layer1_spikes": l1_spikes[g],
                "input_events": in_events,
                "retention_err_v": surf_row[ti],
                "retention_surface_v": list(surf_row),
            }
            records.append(rec)
            log(f"[sweep {protocol} t={t_ms}ms cfg={lab_g}] "
                f"acc={rec['accuracy']:.3f} bw={bw:.4f} "
                f"ret={rec['retention_err_v'] * 1e3:.2f}mV "
                f"train={train_s:.1f}s")

    _normalize(records)
    return GridResult(records=records, retention=retention, labels=labels,
                      grid=grid, protocol=protocol,
                      final_params=final_params, timings=timings)


def run_protocols(data_cfg, model_cfg, sweep, grid: SweepGrid,
                  protocols: tuple[str, ...] = PROTOCOLS,
                  log: Any = print,
                  eval_data=None, keep_params: bool = False,
                  device: str | torch.device | None = None,
                  executor: SweepExecutor | None = None
                  ) -> dict[str, GridResult]:
    """Run the grid under several phase-2 protocols off one shared phase-1
    pretrain. Every protocol draws from a copy of the post-pretrain
    generator, so each sees the same finetune and eval batches."""
    for p in protocols:
        _check_protocol(p)
    data_cfg = sources_mod.as_source(data_cfg)
    sweep = replace(sweep, t_intg_grid_ms=grid.t_intg_grid_ms)
    gen = torch.Generator().manual_seed(sweep.seed)
    pretrained = pretrain_backbone(gen, data_cfg, model_cfg, sweep, log,
                                   device=device)
    return {p: run_grid(data_cfg, model_cfg, sweep, grid, log=log,
                        protocol=p, pretrained=pretrained,
                        executor=executor, eval_data=eval_data,
                        keep_params=keep_params, device=device)
            for p in protocols}


def protocols_artifact(results: dict[str, GridResult],
                       extra_meta: dict | None = None) -> dict:
    """Merge per-protocol grid results into one ``p2m-codesign-sweep/v3``
    artifact: the first protocol's grid and retention metadata, records
    concatenated across protocols."""
    first = next(iter(results.values()))
    art = first.to_artifact()
    del art["protocol"]
    return {**art,
            "schema": SCHEMA_V3,
            "protocols": list(results),
            "records": [r for res in results.values() for r in res.records],
            **(extra_meta or {})}


# ---------------------------------------------------------------------------
# canonical small setup (shared by launch/sweep.py and deploy)
# ---------------------------------------------------------------------------

def paper_setup(fast: bool = False, hw: int = 16,
                dataset: str = "synthetic-gesture",
                data_root: str | None = None):
    """The reference's small defaults: an event source (the synthetic
    generators, or ``dvs128`` / ``nmnist`` under ``data_root``) and the
    P²M model sized to it. Short-recording datasets shrink the backbone
    coarse window to the stream duration and drop T_INTG points that no
    longer fit. Returns (data, model, sweep_cfg, grid)."""
    from repro_torch.core.codesign import P2MModelConfig, SweepConfig
    from repro_torch.core.p2m_layer import P2MConfig
    from repro_torch.core.snn import SpikingCNNConfig

    data = sources_mod.resolve_dataset(dataset, hw=hw, data_root=data_root)
    coarse_ms = min(1000.0, data.duration_ms)
    model = P2MModelConfig(
        p2m=P2MConfig(out_channels=8, n_sub=2),
        backbone=SpikingCNNConfig(channels=(8, 16, 16, 16),
                                  input_hw=(hw, hw), fc_hidden=64,
                                  n_classes=data.n_classes,
                                  first_layer_external=True),
        coarse_window_ms=coarse_ms)
    sweep_cfg = SweepConfig(
        batch_size=2 if fast else 4,
        pretrain_steps=4 if fast else 30,
        finetune_steps=2 if fast else 6,
        eval_batches=2 if fast else 4,
        dataset=dataset, data_root=data_root)
    grid = fast_grid() if fast else paper_grid()
    t_ok = fit_t_grid(grid.t_intg_grid_ms, data.duration_ms, coarse_ms)
    if not t_ok:
        raise ValueError(
            f"no T_INTG grid point fits dataset {dataset!r} "
            f"(duration {data.duration_ms:g} ms, coarse window "
            f"{coarse_ms:g} ms); pass --t-intg values that divide both")
    grid = replace(grid, t_intg_grid_ms=t_ok)
    return data, model, sweep_cfg, grid


def fit_t_grid(t_grid_ms: Sequence[float], duration_ms: float,
               coarse_ms: float) -> tuple[float, ...]:
    """The T_INTG grid points that divide both the stream duration and
    the backbone coarse window."""
    return tuple(t for t in t_grid_ms
                 if _divides(t, coarse_ms) and _divides(t, duration_ms))


def _divides(t_ms: float, span_ms: float) -> bool:
    n = span_ms / t_ms
    return abs(n - round(n)) < 1e-6 and round(n) >= 1
