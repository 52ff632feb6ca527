"""Mesh builders (the port's ``repro.launch.mesh``): functions, not
module constants, so importing never starts a process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the job's
ranks with the reference's axis names. The job's process group comes
from the launcher's environment (``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR``, as ``torchrun`` sets them); a job started without them
is one rank, and :func:`process_group` starts it over an in-process store
(``dist.HashStore``), so nothing opens a port.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def process_group(device: str | torch.device | None = None) -> int:
    """Start the job's default process group if none is running and
    return its world size. With ``RANK`` and ``WORLD_SIZE`` set it joins
    the launcher's job; without, it is a group of one rank over an
    in-process store. Where CUDA is available the group has both
    backends (gloo for CPU tensors, NCCL for CUDA ones), so a CPU mesh
    and a card mesh can follow each other in one process."""
    if dist.is_initialized():
        return dist.get_world_size()
    resolve_device(device)
    backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
               and dist.is_nccl_available() else "gloo")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None):
    """16 × 16 = 256 ranks a pod; 2 pods = 512 ranks when ``multi_pod``.
    A job of another size raises ``ValueError`` naming the count it needs
    (the reference's ``jax.make_mesh`` fails there too)."""
    shape, names = PRODUCTION[multi_pod]
    need = math.prod(shape)
    have = (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", 1)))
    if have != need:
        raise ValueError(f"the production mesh {shape} {names} needs "
                         f"{need} ranks; this job has {have}")
    process_group(device)
    return _mesh(shape, names, device)


def make_host_mesh(model_axis: int | None = None,
                   device: str | torch.device | None = None):
    """("data", "model") mesh over whatever ranks the job has (tests,
    examples, a one-card run): ``model`` is ``model_axis``, or 2 where the
    rank count is even and above 1, else 1. One rank gives ``(1, 1)``."""
    n = process_group(device)
    m = model_axis or (2 if n % 2 == 0 and n > 1 else 1)
    return _mesh((n // m, m), ("data", "model"), device)
