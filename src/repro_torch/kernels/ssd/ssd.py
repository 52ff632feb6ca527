"""Launcher of the CUDA SSD kernel (``csrc/ssd.cu``), the counterpart of
``repro.kernels.ssd.ssd``'s ``ssd_pallas``. ``ops.ssd`` chooses between
it and the plain version by the tensors' device. ``LAUNCHES`` counts
kernel launches, one per call that reached the card.

The kernel reads x ``[b, s, h, p]``, dt ``[b, s, h]`` and B/C
``[b, s, g, n]`` where they lie (no head-major copies, grouped B/C never
expanded) and pads the sequence to the chunk by zero-filled copies. One
call is three launches (each chunk's own state contribution, the state
entering each chunk, the chunk's output) through float32 scratch that the
wrapper allocates: ``[b, ceil(s / chunk), h, p, n]`` and ``[b, ceil(s /
chunk), h]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"ssd": 0}
_ENTRY = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}
CHUNKS = (16, 32, 64, 128)
HEAD_DIMS = (16, 32, 64)
MAX_STATE = 128


def _fn(name: str):
    fn = getattr(_build.load("ssd"), name)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [b,s,h,p] float32/bfloat16, dt [b,s,h] and A [h] float32, B/C
    [b,s,g,n] of x's type, on CUDA → (y [b,s,h,p] of x's type, state
    [b,h,p,n] float32), in three launches counted as one call."""
    from torch.distributed.tensor import DTensor
    args = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    for name, t in args.items():
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a DTensor; the kernel reads local "
                            f"tensors only (ops.ssd runs it on each shard)")
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs every "
                             f"input on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _ENTRY or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x and B must be 4-D, got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s)
            or C.shape != B.shape or g == 0 or h % g or s == 0):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)}")
    if p not in HEAD_DIMS or chunk not in CHUNKS or not 0 < n <= MAX_STATE:
        raise ValueError(f"the kernel takes p in {HEAD_DIMS}, chunk in "
                         f"{CHUNKS} and n <= {MAX_STATE}; got p {p}, chunk "
                         f"{chunk}, n {n}")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    n_chunks = -(-s // chunk)
    u = torch.empty((b, n_chunks, h, p, n), dtype=torch.float32,
                    device=x.device)
    dec = torch.empty((b, n_chunks, h), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn(_ENTRY[x.dtype])(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                  B.data_ptr(), C.data_ptr(), y.data_ptr(),
                                  state.data_ptr(), u.data_ptr(),
                                  dec.data_ptr(), b, s, h, p, g, n, chunk,
                                  stream)
    if rc:
        raise RuntimeError(f"{_ENTRY[x.dtype]} launch failed with cudaError "
                           f"{rc}")
    LAUNCHES["ssd"] += 1
    return y, state

