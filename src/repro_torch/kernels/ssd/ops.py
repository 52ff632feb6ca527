"""The SSD op (``repro.kernels.ssd.ops.ssd`` in PyTorch): a forward drop-in
for the chunked SSD scan of the Mamba-2 block's prefill. On CUDA tensors
it launches the hand-written kernel, on the CPU it runs the plain
sequential recurrence. ``ssd_trainable`` (the backward) comes with the
training slice."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.kernels.ssd.ssd import ssd_cuda


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 128
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan: x [b,s,h,p], dt [b,s,h], A [h], B/C [b,s,g,n] →
    (y [b,s,h,p], state [b,h,p,n] float32)."""
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, B, C)
    return ssd_cuda(x.contiguous(), dt.float().contiguous(),
                    A.float().contiguous(), B.contiguous(), C.contiguous(),
                    chunk=chunk)
