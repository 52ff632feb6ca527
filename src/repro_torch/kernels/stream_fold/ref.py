"""Plain PyTorch versions of the streaming-fold kernels (the sub-slot scan).

The CPU path runs these; on the card they are what ``chip_smoke.py``
holds the CUDA kernels against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.p2m_conv.ops import _extract_patches


def stream_fold_ref(x0: torch.Tensor, deposits: torch.Tensor,
                    a: torch.Tensor) -> torch.Tensor:
    """Fold ``x ← x·a + deposits[s]`` over s. Eager ``x * a + dep`` is two
    separately rounded ops — the sequence the CUDA kernel reproduces
    bit for bit.

    x0 [N, F]; deposits [S, N, F]; a [F] → [N, F].
    """
    x = x0
    for dep in deposits:
        x = x * a + dep
    return x


def stream_fold_mac_ref(x0: torch.Tensor, patches: torch.Tensor,
                        w: torch.Tensor, a: torch.Tensor, *,
                        dv_unit: float) -> torch.Tensor:
    """The same fold with the deposit ``patches[s] @ w · dv_unit``.

    x0 [N, F]; patches [S, N, K]; w [K, F]; a [F] → [N, F].
    """
    x = x0
    for patch in patches:
        x = x * a + (patch @ w) * dv_unit
    return x


def stream_fold_mac_frames_ref(x0: torch.Tensor, frames: torch.Tensor,
                               w: torch.Tensor, a: torch.Tensor, *,
                               stride: int, dv_unit: float) -> torch.Tensor:
    """The same fold on event frames, the contract of the MAC-mode kernel:
    SAME-padded im2col of every sub-slot, then :func:`stream_fold_mac_ref`.

    x0 [B·Ho·Wo, F]; frames [B, S, H, W, Cin]; w [k·k·Cin, F] (rows ordered
    kh, kw, Cin); a [F] → [B·Ho·Wo, F].
    """
    B, S, H, W, Cin = frames.shape
    K, F = w.shape
    k = round((K // Cin) ** 0.5)
    ev = frames.transpose(0, 1).reshape(S * B, H, W, Cin)  # sub-slot major
    patches, _ = _extract_patches(ev, k, stride)            # [S·B, P, K]
    return stream_fold_mac_ref(x0, patches.reshape(S, -1, K), w, a,
                               dv_unit=dv_unit)
