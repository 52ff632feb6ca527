"""The SSD ops (``repro.kernels.ssd.ops`` in PyTorch). ``ssd`` is a
forward drop-in for the chunked SSD scan of the Mamba-2 block's prefill;
``ssd_trainable`` is the training block's scan, its forward the same
kernel and its gradient that of ``nn/ssm.ssd_chunked``. On CUDA tensors
both launch the hand-written kernel, on the CPU they run the plain
sequential recurrence. A shape the kernel does not take raises on CUDA;
there is no fallback to the plain version."""
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


class _SSDTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ctx.save_for_backward(x, dt, A, B, C)
        return ssd(x, dt, A, B, C)[0]

    @staticmethod
    def backward(ctx, gy):
        from repro_torch.nn.ssm import ssd_chunked
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, _ = ssd_chunked(*inputs, chunk=128)
        return torch.autograd.grad(y, inputs, gy)


def ssd_trainable(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """y [b,s,h,p] of x's type: the forward through ``ssd`` (the kernel,
    chunk 128, on CUDA), the backward by recomputing ``ssd_chunked(...,
    chunk=128)`` and differentiating it, as the reference's custom VJP
    does. The kernel's state output is dropped."""
    return _SSDTrainable.apply(x, dt, A, B, C)
