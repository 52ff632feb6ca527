"""Mixture-of-Experts layer (the port's ``repro.nn.moe``): top-k routing
with a capacity per expert, tokens placed into ``[E, C, D]`` buffers by
their rank within their expert (no ``[T, E, C]`` one-hot dispatch tensor).

The order of work is the reference's, so that the same tokens are kept and
dropped: the router runs in float32; ranks are counted choice-major (every
token's first choice before any token's second), so top-1 assignments win
capacity slots first; a dropped choice is clamped onto its expert's last
slot with a zero weight. The combine sums each token's K weighted expert
outputs in choice order, as one gather and K adds in the compute dtype: the
reference's ``.at[tok].add`` done with ``index_add_`` would sum with atomics
on CUDA, whose order (and so the bits) changes from run to run.

``groups`` splits the tokens into that many independent dispatch groups
(capacity, ranks and the placement stay inside a group), the reference's
mesh-local dispatch. Callers pass none: the count is the mesh's batch
shards (``sharding/rules.batch_groups``), so each data shard dispatches
its own rows, and 1 without a mesh or on the one-card ``(1, 1)`` mesh.
On a mesh every rank runs the same per-rank dispatch (``_moe_on_mesh``)
on its own groups, with its experts (EP mode, the experts split over
"model") or its slice of every expert's d_ff (TP mode); one code path at
every rank count.

Training differentiates ``moe_apply`` as it stands, at the config's
capacity factor (serving passes ``serve/steps.serve_config``'s dropless
one): the gradient reaches ``x`` through the placement and the router,
the router through the gate values and the load-balance loss's mean
probabilities, and the experts' weights through their products. A dropped
choice is never placed and has a zero combine weight, so its gradient is
0, as in the reference. Each row the backward pass scatters into takes
one gradient, or exact zeros beside it, or is the discarded zero row, so
the gradients do not depend on the order in which CUDA's atomics land.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.nn.layers import _act, _normal, cdt, pdt
from repro_torch.sharding import rules

Params = dict


def moe_init(gen, cfg: LMConfig, lead: tuple = ()) -> Params:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(D)
    dt = pdt(cfg)
    return {
        "router": _normal(gen, lead + (D, E), s, torch.float32),
        "wg": _normal(gen, lead + (E, D, Fd), s, dt),
        "wu": _normal(gen, lead + (E, D, Fd), s, dt),
        "wd": _normal(gen, lead + (E, Fd, D),
                      (1.0 / math.sqrt(Fd)) / math.sqrt(2 * cfg.n_layers), dt),
    }


def capacity(n_tokens: int, cfg: LMConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens, rounded up to 8."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def moe_apply(p: Params, x: torch.Tensor, cfg: LMConfig,
              groups: int | None = None) -> tuple[torch.Tensor, dict]:
    """x [B, S, D] → (y [B, S, D], {"lb_loss", "drop_frac"}): the Switch
    load-balance loss and the share of (token, choice) pairs dropped for
    want of capacity, both float32 scalars, over every group.

    ``groups`` defaults to the batch shards of x's mesh, or of the
    ambient mesh (``rules.current_mesh``) for a plain tensor, as the
    reference's ``_batch_groups``: 1 without a mesh. On DTensors it runs
    :func:`_moe_on_mesh`."""
    B, S, D = x.shape
    T = B * S
    G = groups if groups is not None else rules.batch_groups(
        getattr(x, "device_mesh", None) or rules.current_mesh(), T)
    if G < 1 or T % G:
        raise ValueError(f"{G} dispatch groups do not divide {T} tokens")
    if hasattr(x, "placements"):
        return _moe_on_mesh(p, x, cfg, G)
    y, density, density_prob, kept = _dispatch(p, x, cfg, G, 0)
    return y, _aux(density, density_prob, kept, cfg)


def _aux(density, density_prob, kept, cfg: LMConfig) -> dict:
    return {"lb_loss": cfg.n_experts * (density * density_prob).sum(),
            "drop_frac": 1.0 - kept}


def _dispatch(p: Params, x: torch.Tensor, cfg: LMConfig, G: int, e0: int
              ) -> tuple[torch.Tensor, ...]:
    """The grouped dispatch of x [B, S, D] in ``G`` groups onto the
    experts ``p`` holds: all ``E`` of them, or ``p["wg"].shape[0]`` from
    expert ``e0`` on (a rank's share in EP mode), each whole or a d_ff
    slice of it (TP mode). Returns (y, density, density_prob, kept): y
    holds these experts' (or this slice's) share of every output, the
    rest the means over the groups behind the load-balance loss and the
    drop share (top-1 density, mean router probability, kept share)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    El = p["wg"].shape[0]
    T = B * S
    Tg = T // G
    Cg = capacity(Tg, cfg)
    dt = cdt(cfg)
    dev = x.device
    xg = x.reshape(G, Tg, D)

    logits = xg.float() @ p["router"].float()                 # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)      # [G, Tg, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # rank within (group, expert), choice-major; the count runs along the
    # innermost dim of an expert-major one-hot: on CUDA a cumsum along an
    # outer dim walks its K*Tg steps one after another (3 ms a layer of
    # granite's prefill on an H100)
    flat_e = expert_idx.transpose(1, 2).reshape(G, K * Tg)
    onehot = F.one_hot(flat_e, E).transpose(1, 2).contiguous()  # [G,E,K*Tg]
    rank = ((torch.cumsum(onehot, dim=-1) - onehot) * onehot).sum(1)
    keep = rank < Cg
    density = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    density_prob = probs.mean(dim=(0, 1))
    kept = keep.float().mean()

    # place the kept (token, choice) rows into per-group [El * Cg, D]
    # buffers by a gather: each slot reads the one choice that fills it
    # (kept slots are distinct), an empty slot the zero row n. A dropped
    # choice writes its index into a spare column of its own, so the
    # scatter has no duplicate index and the host never waits for a count
    n = K * Tg
    slot = flat_e * Cg + torch.clamp(rank, max=Cg - 1)        # [G, n]
    j = torch.arange(n, device=dev).expand(G, n)
    src = torch.full((G, E * Cg + n), n, dtype=torch.long, device=dev
                     ).scatter(1, torch.where(keep, slot, E * Cg + j), j)
    rows = torch.cat([xg.to(dt).repeat(1, K, 1),              # row j: token
                      xg.new_zeros((G, 1, D), dtype=dt)], 1)  # j mod Tg
    buf = torch.gather(rows, 1, src[:, e0 * Cg:(e0 + El) * Cg, None]
                       .expand(-1, -1, D))

    # the experts' GLU over expert-major [El, G*Cg, D]
    bufe = buf.reshape(G, El, Cg, D).transpose(0, 1).reshape(El, G * Cg, D)
    h = _act(torch.bmm(bufe, p["wg"].to(dt)), cfg.act)
    h = h * torch.bmm(bufe, p["wu"].to(dt))
    out = torch.bmm(h, p["wd"].to(dt))                       # [El, G*Cg, D]
    outg = out.reshape(El, G, Cg, D).transpose(0, 1).reshape(G, El * Cg, D)

    # combine: each token's K weighted outputs summed in choice order (a
    # choice of an expert held elsewhere weighs 0 here)
    if El != E:
        keep = keep & (flat_e >= e0) & (flat_e < e0 + El)
        slot = torch.clamp(slot - e0 * Cg, 0, El * Cg - 1)
    w = (gate_vals.transpose(1, 2).reshape(G, K * Tg)
         * keep.float()).to(dt)                               # [G, K*Tg]
    contrib = (torch.gather(outg, 1, slot[..., None].expand(-1, -1, D))
               * w[..., None]).reshape(G, K, Tg, D)
    y = torch.zeros((G, Tg, D), dtype=dt, device=dev)
    for k in range(K):
        y = y + contrib[:, k]
    return y.reshape(B, S, D), density, density_prob, kept


def _moe_on_mesh(p: Params, x: torch.Tensor, cfg: LMConfig, G: int
                 ) -> tuple[torch.Tensor, dict]:
    """:func:`moe_apply` on DTensors, at any rank count: each rank runs
    :func:`_dispatch` on its own groups and its experts (EP) or d_ff slice
    (TP) through ``local_map``, in ``rules.moe_placements``. The
    dispatch's gathers and scatters then see plain tensors (torch 2.11's
    DTensor propagates neither's backward). y leaves as a ``Partial`` sum
    over "model" when the weights split there; the means behind the aux
    outputs as each rank's share of a sum over the batch shards, reduced
    here. At one rank every placement replicates, and the bits are the
    unsharded call's."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = rules.moe_placements(cfg, mesh, tuple(x.shape))
    if G % pl.row_shards:
        raise ValueError(f"{G} dispatch groups do not split over "
                         f"{pl.row_shards} batch shards")
    ep = pl.split and pl.mode == "EP"
    m_rank = mesh.get_local_rank("model") if pl.split else 0
    El = cfg.n_experts // (rules.axis_sizes(mesh)["model"] if ep else 1)
    e0 = m_rank * El if ep else 0
    names = ("router", "wg", "wu", "wd")
    nb = pl.row_shards

    def local(x, *leaves):
        y, density, density_prob, kept = _dispatch(
            dict(zip(names, leaves)), x, cfg, G // nb, e0)
        if nb > 1:
            density, density_prob, kept = (t / nb for t in (
                density, density_prob, kept))
        if m_rank:
            # counted on the first "model" rank alone: the router's
            # gradient through the load-balance loss joins the Partial
            # sum its gradient through y is over "model"
            density_prob = torch.zeros_like(density_prob)
        return y, density, density_prob, kept
    y, *means = local_map(
        local, out_placements=(pl.y, pl.sums, pl.prob_sums, pl.sums),
        in_placements=(pl.x,) + tuple(pl.weights[k] for k in names),
        in_grad_placements=(pl.y,) + tuple(pl.grads[k] for k in names),
        device_mesh=mesh, redistribute_inputs=True)(x, *(p[k] for k in names))
    rep = (Replicate(),) * mesh.ndim
    return y, _aux(*(t.redistribute(mesh, rep) for t in means), cfg)
