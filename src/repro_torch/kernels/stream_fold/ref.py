"""Plain PyTorch versions of the streaming-fold kernels (the sub-slot scan).

The CPU path runs these; on the card they are what ``chip_smoke.py``
holds the CUDA kernels against.
"""
from __future__ import annotations

import torch


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
