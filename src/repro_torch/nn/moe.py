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
mesh-local dispatch. One card has no mesh, so every path passes 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.nn.layers import _act, _normal, cdt, pdt

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


def moe_apply(p: Params, x: torch.Tensor, cfg: LMConfig, groups: int = 1
              ) -> tuple[torch.Tensor, dict]:
    """x [B, S, D] → (y [B, S, D], {"lb_loss", "drop_frac"}): the Switch
    load-balance loss and the share of (token, choice) pairs dropped for
    want of capacity, both float32 scalars."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = groups
    if G < 1 or T % G:
        raise ValueError(f"{G} dispatch groups do not divide {T} tokens")
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
    aux = {"lb_loss": E * (density * density_prob).sum(),
           "drop_frac": 1.0 - keep.float().mean()}

    # place the kept (token, choice) rows into per-group [E * Cg, D]
    # buffers; kept slots are distinct, so this is a plain assignment
    slot = flat_e * Cg + torch.clamp(rank, max=Cg - 1)        # [G, K*Tg]
    tok = torch.arange(Tg, device=dev).repeat(K)               # [K*Tg]
    gi = torch.arange(G, device=dev)[:, None].expand(G, K * Tg)
    buf = torch.zeros((G, E * Cg, D), dtype=dt, device=dev)
    buf[gi[keep], slot[keep]] = xg.to(dt)[gi[keep], tok.expand(G, -1)[keep]]

    # the experts' GLU over expert-major [E, G*Cg, D]
    bufe = buf.reshape(G, E, Cg, D).transpose(0, 1).reshape(E, G * Cg, D)
    h = _act(torch.bmm(bufe, p["wg"].to(dt)), cfg.act)
    h = h * torch.bmm(bufe, p["wu"].to(dt))
    out = torch.bmm(h, p["wd"].to(dt))                        # [E, G*Cg, D]
    outg = out.reshape(E, G, Cg, D).transpose(0, 1).reshape(G, E * Cg, D)

    # combine: each token's K weighted outputs summed in choice order
    w = (gate_vals.transpose(1, 2).reshape(G, K * Tg)
         * keep.float()).to(dt)                               # [G, K*Tg]
    contrib = (torch.gather(outg, 1, slot[..., None].expand(-1, -1, D))
               * w[..., None]).reshape(G, K, Tg, D)
    y = torch.zeros((G, Tg, D), dtype=dt, device=dev)
    for k in range(K):
        y = y + contrib[:, k]
    return y.reshape(B, S, D), aux
