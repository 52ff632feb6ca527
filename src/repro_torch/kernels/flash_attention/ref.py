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

# KV keys per online-softmax chunk of a narrow-type attention_ref: the CUDA
# kernel's kv tile
KV_CHUNK = 128


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, kv_len: int | None = None,
                  chunk: int = KV_CHUNK) -> torch.Tensor:
    """q [BH, Sq, d], k/v [BH, Skv, d] → o [BH, Sq, d] of q's type.

    float32: one softmax over the whole row. A narrower type (bf16) takes
    the order of work of ``nn.layers.attention_core``, as the reference's
    prefill and the CUDA kernel do: an online softmax over KV chunks of
    ``chunk`` keys in float32, with each chunk's unnormalised P rounded to
    q's type before PV."""
    BH, Sq, d = q.shape
    Skv = k.shape[1]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    if kv_len is not None:
        mask = mask & (torch.arange(Skv, device=q.device)[None, :] < kv_len)
    if q.dtype != torch.float32:
        return _online_softmax(q, k, v, mask, chunk)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _online_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, chunk: int) -> torch.Tensor:
    """:func:`attention_ref` for a narrow q: ``attention_core``'s loop over
    KV chunks (statistics in float32, P rounded to q's type before PV)."""
    BH, Sq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((BH, Sq), -math.inf, device=q.device)
    l = torch.zeros((BH, Sq), device=q.device)
    acc = torch.zeros((BH, Sq, d), device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kb, vb = k[:, c0:c0 + chunk].float(), v[:, c0:c0 + chunk].float()
        s = torch.einsum("bqd,bkd->bqk", qf, kb) * scale
        s = s.masked_fill(~mask[:, c0:c0 + chunk], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # fully-masked rows (m_new = -inf) contribute nothing
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqk,bkd->bqd", p.to(q.dtype).float(), vb)
        m = m_new
    return (acc / torch.clamp(l[..., None], min=1e-20)).to(q.dtype)


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, kv_len: int | None = None,
                      chunk: int = KV_CHUNK) -> torch.Tensor:
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
    o = attention_ref(qf, kf, vf, causal=causal, kv_len=kv_len,
                      chunk=chunk)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)
