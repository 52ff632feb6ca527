"""GQA attention shaped like ``nn.layers.attention_core``
(``repro.kernels.flash_attention.ops`` in PyTorch), forward only: the
prefill's causal self-attention. On CUDA tensors it launches the
hand-written kernel, which indexes the kv head as ``h // G`` instead of
repeating K/V; on the CPU it runs the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    gqa_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (
    KV_CHUNK, gqa_attention_ref)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, kv_len: int | None = None,
                  chunk: int = KV_CHUNK) -> torch.Tensor:
    """q [B, Sq, H, hd]; k/v [B, Skv, KV, hd], H % KV == 0 → [B, Sq, H, hd].
    ``chunk``: the KV chunk over which the plain version rounds P when q is
    narrower than float32 (the kernel's own kv tile is 128 keys, 64 at
    head dim 256)."""
    if q.device.type == "cpu":
        return gqa_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                 chunk=chunk)
    return gqa_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, kv_len=kv_len)
