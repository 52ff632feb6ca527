"""Plain PyTorch version of the flash-attention kernel
(``repro.kernels.flash_attention.ref.attention_ref``): full-materialisation
attention with a float32 softmax, and ``gqa_attention_ref``, the same in
``ops.gqa_attention``'s ``[B, S, H, hd]`` layout.

The CPU path runs it; on the card it is what ``chip_smoke.py`` holds the
CUDA kernel against.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, kv_len: int | None = None
                  ) -> torch.Tensor:
    """q [BH, Sq, d], k/v [BH, Skv, d] → o [BH, Sq, d] of q's type."""
    BH, Sq, d = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    if kv_len is not None:
        mask = mask & (torch.arange(Skv, device=q.device)[None, :] < kv_len)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, kv_len: int | None = None
                      ) -> torch.Tensor:
    """q [B, Sq, H, hd]; k/v [B, Skv, KV, hd] → [B, Sq, H, hd]: K/V repeated
    to every query head, heads flattened, :func:`attention_ref`."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = k.transpose(1, 2).reshape(B * H, Skv, hd)
    vf = v.transpose(1, 2).reshape(B * H, Skv, hd)
    o = attention_ref(qf, kf, vf, causal=causal, kv_len=kv_len)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)
