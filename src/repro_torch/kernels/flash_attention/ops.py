"""GQA attention shaped like ``nn.layers.attention_core``
(``repro.kernels.flash_attention.ops`` in PyTorch), forward only: the
prefill's causal self-attention. On CUDA tensors it launches the
hand-written kernel, which indexes the kv head as ``h // G`` instead of
repeating K/V; on the CPU it runs the plain version.

On DTensors (a sharded step, ``sharding/rules.py``) it runs on each
rank's local shard through ``local_map``: the batch over the batch axes
and the heads over "model" (q's and k/v's alike, so a query head's kv
head ``h // G`` stays on its rank), inputs redistributed to that
placement where they arrive otherwise. The kernel's wrapper itself
refuses a DTensor."""
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
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _sharded(q, k, v, causal=causal, kv_len=kv_len, chunk=chunk)
    if q.device.type == "cpu":
        return gqa_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                 chunk=chunk)
    return gqa_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, kv_len=kv_len)


def _sharded(q, k, v, **kw):
    """:func:`gqa_attention` on each rank's shard of DTensors q, k, v."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import head_placements
    pq, pkv = head_placements(q, k)
    return local_map(lambda q, k, v: gqa_attention(q, k, v, **kw),
                     out_placements=list(pq), in_placements=(pq, pkv, pkv),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)
