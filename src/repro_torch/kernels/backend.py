"""Device resolution for the port (the counterpart of
``repro.kernels.backend``, whose job — choosing compiled vs interpreted
kernels — the tensor's device does here).

On ``cuda`` every kernel wrapper launches its hand-written kernel; on the
CPU it runs the plain PyTorch version beside it. The device is the only
switch: there is no ``use_kernel`` flag and no silent fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``. A ``cuda`` device without a GPU raises (pass
    ``device="cpu"`` to run on the CPU). Resolving a ``cuda`` device also
    turns TF32 off for cuDNN convolutions and cuBLAS matmuls: cuDNN's
    default (TF32 on) keeps ~3 decimal digits, which would break every
    float32 tolerance the port is held to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev
