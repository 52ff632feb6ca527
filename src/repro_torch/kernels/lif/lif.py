"""Wrapper of the CUDA LIF kernel (``csrc/lif.cu``), the counterpart of
``repro.kernels.lif.lif``'s ``lif_pallas``. A tensor on the CPU goes to
the plain version in ``ref.py``; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches by route, one per call that
reached the card: ``lif`` the wide lanes (16 or 8 bytes of a row a
thread: many columns), ``lif_narrow`` the narrow ones (4 bytes, or one
bfloat16 column where rows do not start on 4 bytes: few columns, or a
row layout the wide lanes cannot take).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lif.ref import lif_ref

LAUNCHES = {"lif": 0, "lif_narrow": 0}
_ENTRY = {torch.float32: "lif_f32", torch.bfloat16: "lif_bf16"}
# the widest lane is taken while it leaves at least this many threads
# (~500 a SM on the H100's 132): fewer, wider lanes leave SMs idle, and
# the scan over T then waits out memory latency in each
MIN_THREADS = 65536


def _fn(name: str):
    fn = getattr(_build.load("lif"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lif_lane(x: torch.Tensor) -> int:
    """Bytes of a row each thread takes: the widest of 16, 8 and 4 that
    the row layout allows (x 16-, 8- or 4-byte aligned and N · size a
    multiple of it) and that leaves :data:`MIN_THREADS` threads (4 is
    taken whatever the count); else one element (bfloat16 rows off the
    4-byte grid)."""
    row = x.shape[-1] * x.element_size()
    for lane in (16, 8, 4):
        if (x.data_ptr() % lane == 0 and row % lane == 0
                and (row // lane >= MIN_THREADS or lane == 4)):
            return lane
    return x.element_size()


def lif_route(x: torch.Tensor) -> str:
    """The ``LAUNCHES`` key the kernel counts a launch on x under."""
    return "lif" if lif_lane(x) >= 8 else "lif_narrow"


def quotient_mode(tau: float) -> int:
    """How the kernel divides by ``tau`` (already in the working type):
    0, multiply by 1/tau — a power of two whose reciprocal is a normal
    float32, where the product rounds the same real number as the
    division, so the two agree in every bit; 1, Markstein's correction
    step from RN(1/tau) (2^-20 ≤ tau ≤ 2^20); 2, true division."""
    if not tau > 0 or math.isinf(tau):
        return 2
    m, e = math.frexp(tau)            # tau = m · 2^e, 0.5 ≤ m < 1
    if m == 0.5 and -126 <= 1 - e <= 127:
        return 0
    return 1 if 2.0 ** -20 <= tau <= 2.0 ** 20 else 2


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
    T, N = x.shape
    if T >= 2 ** 31:
        raise ValueError(f"T = {T} does not fit the kernel's int steps")
    # the kernel compares, resets and divides with the constants rounded
    # to x's type, as the plain version's 0-dim tensors do
    tau_x = float(torch.tensor(tau, dtype=x.dtype))
    vth_x = float(torch.tensor(v_th, dtype=x.dtype))
    qmode = quotient_mode(tau_x)
    inv = 1.0 / tau_x if qmode == 0 else 0.0
    recip = float(np.float32(1.0) / np.float32(tau_x)) if qmode == 1 else 0.0
    lane = lif_lane(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn(_ENTRY[x.dtype])(
            x.data_ptr(), out.data_ptr(), T, N, tau_x, inv, recip, vth_x,
            qmode, int(bool(soft_reset)), lane, stream)
    if rc:
        raise RuntimeError(f"{_ENTRY[x.dtype]} launch failed with "
                           f"cudaError {rc}")
    LAUNCHES["lif" if lane >= 8 else "lif_narrow"] += 1
    return out


def lif(x: torch.Tensor, *, tau: float = 2.0, v_th: float = 1.0,
        soft_reset: bool = True) -> torch.Tensor:
    """The LIF scan: the plain version on the CPU, the kernel on CUDA."""
    fn = lif_ref if x.device.type == "cpu" else lif_cuda
    return fn(x, tau=tau, v_th=v_th, soft_reset=soft_reset)
