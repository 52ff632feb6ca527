"""Wrapper of the CUDA LIF kernel (``csrc/lif.cu``), the counterpart of
``repro.kernels.lif.lif``'s ``lif_pallas``. A tensor on the CPU goes to
the plain version in ``ref.py``; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches, one per call that reached
the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lif.ref import lif_ref

LAUNCHES = {"lif": 0}
# per type: the C entry point and the columns one 16-byte load covers
_ENTRY = {torch.float32: ("lif_f32", 4), torch.bfloat16: ("lif_bf16", 8)}
# below this many threads (a wave of 256-thread blocks on the H100's 132
# SMs) one column per thread keeps more of the card busy than 16-byte loads
_MIN_VECTOR_THREADS = 132 * 256


def _fn(name: str):
    fn = getattr(_build.load("lif"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lif_cuda(x: torch.Tensor, *, tau: float = 2.0, v_th: float = 1.0,
             soft_reset: bool = True) -> torch.Tensor:
    """x [T, N] float32 or bfloat16 on CUDA → spikes [T, N] of the same
    type, in one launch; bit-exact with :func:`lif_ref` on the card."""
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}; the kernel needs a CUDA tensor")
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty [T, N], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    name, vec = _ENTRY[x.dtype]
    T, N = x.shape
    if N % vec or x.data_ptr() % 16 or N // vec < _MIN_VECTOR_THREADS:
        vec = 1
    # the kernel compares and resets with the constants rounded to x's type,
    # as the plain version's 0-dim tensors are
    tau_x = float(torch.tensor(tau, dtype=x.dtype))
    vth_x = float(torch.tensor(v_th, dtype=x.dtype))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn(name)(x.data_ptr(), out.data_ptr(), T, N, tau_x, vth_x,
                       int(bool(soft_reset)), vec, stream)
    if rc:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")
    LAUNCHES["lif"] += 1
    return out


def lif(x: torch.Tensor, *, tau: float = 2.0, v_th: float = 1.0,
        soft_reset: bool = True) -> torch.Tensor:
    """The LIF scan: the plain version on the CPU, the kernel on CUDA."""
    fn = lif_ref if x.device.type == "cpu" else lif_cuda
    return fn(x, tau=tau, v_th=v_th, soft_reset=soft_reset)
