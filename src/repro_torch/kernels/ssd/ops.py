"""The SSD ops (``repro.kernels.ssd.ops`` in PyTorch). ``ssd`` is a
forward drop-in for the chunked SSD scan of the Mamba-2 block's prefill;
``ssd_trainable`` is the training block's scan, its forward the same
kernel and its gradient that of ``nn/ssm.ssd_chunked``. On CUDA tensors
both launch the hand-written kernel, on the CPU they run the plain
sequential recurrence. A shape the kernel does not take raises on CUDA;
there is no fallback to the plain version.

On DTensors (a sharded step, ``sharding/rules.py``) both run on each
rank's local shard through ``local_map`` (:func:`on_shards`): the batch
over the batch axes and the heads over "model"; B and C shard their
groups with the heads, or replicate when there is one group. The kernel's
wrapper itself refuses a DTensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.kernels.ssd.ssd import ssd_cuda


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 128
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan: x [b,s,h,p], dt [b,s,h], A [h], B/C [b,s,g,n] →
    (y [b,s,h,p], state [b,h,p,n] float32)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return on_shards(lambda *a: ssd(*a, chunk=chunk), x, dt, A, B, C)
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
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return on_shards(_SSDTrainable.apply, x, dt, A, B, C, state=False)
    return _SSDTrainable.apply(x, dt, A, B, C)


def on_shards(fn, x, dt, A, B, C, state: bool = True):
    """``fn(x, dt, A, B, C)`` → (y, state), or y alone without ``state``,
    run on each rank's local shards of DTensor inputs. Heads shard over
    "model" where h (and B/C's groups, unless there is one) divides it;
    the batch over the batch axes where b divides. Gradients: A's sums
    over the batch shards and B/C's over the head shards (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import local_placements
    mesh = x.device_mesh
    model = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    g = B.shape[2]
    heads = x.shape[2] % model == 0 and model > 1
    if heads and g > 1 and g % model:
        raise ValueError(f"ssd on shards: {g} groups of B/C do not follow "
                         f"{x.shape[2]} heads onto {model} model shards")
    px = local_placements(mesh, x.shape, 0, 2 if heads else None)
    pdt = local_placements(mesh, dt.shape, 0, 2 if heads else None)
    pa = local_placements(mesh, A.shape, None, 0 if heads else None)
    pbc = local_placements(mesh, B.shape, 0, 2 if heads and g > 1 else None)
    pst = local_placements(mesh, (x.shape[0],) + tuple(x.shape[2:]), 0,
                           1 if heads else None)
    # the gradient of an input replicated over a mesh dim that shards the
    # output is a partial sum there
    ga = tuple(Partial() if isinstance(p_x, Shard) and p_x.dim == 0 else p_a
               for p_x, p_a in zip(px, pa))
    gbc = tuple(Partial() if isinstance(p_x, Shard) and p_x.dim == 2
                and isinstance(p_b, Replicate) else p_b
                for p_x, p_b in zip(px, pbc))
    # one output takes a list: local_map reads a tuple as one per output
    return local_map(fn, out_placements=(px, pst) if state else list(px),
                     in_placements=(px, pdt, pa, pbc, pbc),
                     in_grad_placements=(px, pdt, ga, gbc, gbc),
                     device_mesh=mesh, redistribute_inputs=True
                     )(x, dt, A, B, C)
