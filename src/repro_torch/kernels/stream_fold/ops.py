"""Serving-shaped wrapper: replay-chunk frames → one streaming-fold kernel
launch (``repro.kernels.stream_fold.ops`` in PyTorch).

``mode="deposit"`` computes the per-sub-slot conv deposits (one batched
SAME conv over all sub-slots) and folds them in the kernel — bit-exact
with the plain fold on the same device. ``mode="mac"`` hands the frames to a
kernel that does the im2col and the product itself, so neither patches
nor the [S, N, F] deposit tensor reach device memory (≤ 1e-5 from deposit
mode).
"""
from __future__ import annotations

import torch

from repro_torch.core.p2m_layer import _conv
from repro_torch.kernels.stream_fold.stream_fold import (
    stream_fold, stream_fold_mac,
)

MODES = ("deposit", "mac")


def fold_chunk(x: torch.Tensor, frames: torch.Tensor, w_q: torch.Tensor,
               a: torch.Tensor, *, stride: int, dv_unit: float,
               mode: str = "deposit") -> torch.Tensor:
    """``x ← x·a + conv(ev_s)·dv_unit`` over the chunk's S sub-slots.

    x [B, Ho, Wo, F] per-lane charge (conv output resolution); frames
    [B, S, H, W, Cin] the chunk's events per fine sub-slot; w_q
    [k, k, Cin, F] quantized weights; a [F] per-filter decay. Returns the
    advanced charge, shaped like ``x``.
    """
    B, S, H, W, Cin = frames.shape
    F = w_q.shape[-1]
    x_flat = x.reshape(-1, F)
    N = x_flat.shape[0]
    if mode == "deposit":
        ev = frames.transpose(0, 1).reshape(S * B, H, W, Cin)  # sub-slot major
        dep = (_conv(ev, w_q, stride) * dv_unit).reshape(S, N, F)
        out = stream_fold(x_flat, dep, a)
    elif mode == "mac":
        out = stream_fold_mac(x_flat, frames.contiguous(),
                              w_q.reshape(-1, F), a, stride=stride,
                              dv_unit=dv_unit)
    else:
        raise ValueError(f"unknown stream_fold mode {mode!r} "
                         f"(expected one of {MODES})")
    return out.reshape(x.shape)
