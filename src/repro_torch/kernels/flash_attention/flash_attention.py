"""Launcher of the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the counterpart of ``repro.kernels.flash_attention.flash_attention``'s
``flash_attention_pallas``. ``ops.gqa_attention`` chooses between it and
the plain version by the tensors' device. ``LAUNCHES`` counts kernel
launches, one per call that reached the card.

The kernel reads q ``[B, Sq, H, d]`` and k/v ``[B, Skv, KV, d]`` where
they lie (the layout the projections produce) and indexes the kv head of
query head ``h`` as ``h // (H / KV)``: GQA needs no repeated K/V and no
transposes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0}
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)


def _fn(name: str):
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gqa_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, kv_len: int | None = None
                       ) -> torch.Tensor:
    """q [B, Sq, H, d], k/v [B, Skv, KV, d] (H % KV == 0) on CUDA →
    o [B, Sq, H, d] of q's type, in one launch."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA "
                             f"tensors")
        if t.dtype not in _ENTRY or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, got "
                            f"{t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor, got "
                             f"{tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the kernel "
                             f"reads rows with 16-byte loads)")
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != d
            or H % KV or d not in HEAD_DIMS or Sq == 0 or Skv == 0):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (head dim in {HEAD_DIMS})")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    kv_len = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn(_ENTRY[q.dtype])(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), B, H, KV, Sq, Skv, d,
                                  kv_len, int(bool(causal)), stream)
    if rc:
        raise RuntimeError(f"{_ENTRY[q.dtype]} launch failed with cudaError "
                           f"{rc}")
    LAUNCHES["flash_attention"] += 1
    return out

