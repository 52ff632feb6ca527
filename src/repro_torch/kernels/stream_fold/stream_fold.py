"""Wrappers of the CUDA streaming-fold kernels (``csrc/stream_fold.cu``).

The counterparts of ``repro.kernels.stream_fold.stream_fold``'s
``stream_fold_pallas`` / ``stream_fold_mac_pallas``. A tensor on the CPU
goes to the plain version in ``ref.py``; a CUDA tensor launches the kernel
or raises. ``LAUNCHES`` counts kernel launches, one per call that reached
the card. The deposit-mode fold has two hand-written routes, chosen by
shape (:func:`fold_route`): a float4 kernel where F % 4 == 0 and every
buffer is 16-byte aligned (counted as ``fold``), a one-float-per-thread
kernel otherwise (counted as ``fold_scalar``). So has the MAC-mode fold
(:func:`mac_route`): tiles loaded by TMA and products on the tensor cores
for the 3×3 kernel over ON/OFF with F % 8 == 0, W even and x0 and the
frames 16-byte aligned (counted as ``fold_mac``), cp.async and FMA loops
for any other shape (``fold_mac_cp``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.snn import same_pads
from repro_torch.kernels import _build
from repro_torch.kernels.stream_fold.ref import (
    stream_fold_mac_frames_ref, stream_fold_ref,
)

LAUNCHES = {"fold": 0, "fold_scalar": 0, "fold_mac": 0, "fold_mac_cp": 0}
_MAX_SHARED_BYTES = 232448  # what one block may opt in to on Hopper

_P = ctypes.c_void_p
_SIGNATURES = {
    "stream_fold_f32": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, _P],
    "stream_fold_x4_f32": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, _P],
    "stream_fold_mac_f32": [_P] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 11
                           + [ctypes.c_float, _P],
    "stream_fold_mac_cp_f32": [_P] * 5 + [ctypes.c_longlong]
                              + [ctypes.c_int] * 11 + [ctypes.c_float, _P],
    "stream_fold_mac_shmem_bytes": [ctypes.c_int] * 6,
}


def _fn(name: str):
    fn = getattr(_build.load("stream_fold"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = (ctypes.c_longlong if name.endswith("_bytes")
                  else ctypes.c_int)
    return fn


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check(ts: dict[str, torch.Tensor], shapes: dict[str, tuple]) -> None:
    dev = ts["x0"].device
    for name, t in ts.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every input must be "
                             f"on one CUDA device (x0 is on {dev})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(name: str, counter: str, out: torch.Tensor, *args) -> None:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = _fn(name)(*args, stream)
    if rc:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")
    LAUNCHES[counter] += 1


def fold_route(*ts: torch.Tensor) -> str:
    """``"vector"`` when the deposit-mode fold over these buffers (x0,
    deposits, a, out) can run four floats a thread — F, their last
    dimension, a multiple of 4 and each one 16-byte aligned — else
    ``"scalar"``."""
    vector = (ts[0].shape[-1] % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in ts))
    return "vector" if vector else "scalar"


_FOLD_ENTRY = {"vector": ("stream_fold_x4_f32", "fold"),
               "scalar": ("stream_fold_f32", "fold_scalar")}


def stream_fold_cuda(x0: torch.Tensor, deposits: torch.Tensor,
                     a: torch.Tensor) -> torch.Tensor:
    """``x ← x·a + deposits[s]`` over all S sub-slots in one launch; bit-exact
    with :func:`~repro_torch.kernels.stream_fold.ref.stream_fold_ref` on
    the card. x0 [N, F]; deposits [S, N, F]; a [F] → [N, F]. The kernel is
    the one :func:`fold_route` chooses for these buffers."""
    if deposits.dim() != 3:
        raise ValueError(f"deposits must be [S, N, F], got "
                         f"{tuple(deposits.shape)}")
    S, N, F = deposits.shape
    if N * F == 0:
        raise ValueError("stream_fold needs N > 0 and F > 0")
    _check({"x0": x0, "deposits": deposits, "a": a},
           {"x0": (N, F), "deposits": (S, N, F), "a": (F,)})
    out = torch.empty_like(x0)
    entry, counter = _FOLD_ENTRY[fold_route(x0, deposits, a, out)]
    _launch(entry, counter, out, x0.data_ptr(), deposits.data_ptr(),
            a.data_ptr(), out.data_ptr(), N, F, S)
    return out


def mac_route(x0: torch.Tensor, frames: torch.Tensor, w: torch.Tensor
              ) -> str:
    """``"tma"`` when the MAC-mode fold over these buffers can load its
    tiles by TMA and take its products on the tensor cores — a 3×3 kernel
    (w [18, F]) over Cin 2, F % 8 == 0 and at most 256, W even, x0 and the
    frames 16-byte aligned — else ``"cp"``."""
    F = w.shape[-1]
    tma = (frames.shape[-1] == 2 and w.shape[0] == 18 and F % 8 == 0
           and F <= 256 and frames.shape[-2] % 2 == 0
           and x0.data_ptr() % 16 == 0 and frames.data_ptr() % 16 == 0)
    return "tma" if tma else "cp"


_MAC_ENTRY = {"tma": ("stream_fold_mac_f32", "fold_mac"),
              "cp": ("stream_fold_mac_cp_f32", "fold_mac_cp")}


def stream_fold_mac_cuda(x0: torch.Tensor, frames: torch.Tensor,
                         w: torch.Tensor, a: torch.Tensor, *, stride: int,
                         dv_unit: float) -> torch.Tensor:
    """The fully fused fold: the deposit, the SAME conv of each sub-slot's
    event frame with w times ``dv_unit``, is computed in the kernel from the
    frames. x0 [B·Ho·Wo, F]; frames [B, S, H, W, Cin]; w [k·k·Cin, F] (rows
    ordered kh, kw, Cin); a [F] → [B·Ho·Wo, F]. Matches
    :func:`~repro_torch.kernels.stream_fold.ref.stream_fold_mac_frames_ref`
    to summation order (≤ 1e-5). The kernel is the one :func:`mac_route`
    chooses for these buffers."""
    if frames.dim() != 5 or w.dim() != 2:
        raise ValueError(f"frames must be [B, S, H, W, Cin] and w [K, F], "
                         f"got {tuple(frames.shape)} and {tuple(w.shape)}")
    B, S, H, W, Cin = frames.shape
    K, F = w.shape
    k = round((K // max(Cin, 1)) ** 0.5)
    if B * S * H * W * Cin * F == 0 or k * k * Cin != K or stride < 1:
        raise ValueError(f"stream_fold_mac needs non-empty frames, F > 0, "
                         f"stride >= 1 and K = k·k·Cin rows of w, got "
                         f"frames {tuple(frames.shape)} and w [{K}, {F}]")
    ho, wo = -(-H // stride), -(-W // stride)
    _check({"x0": x0, "frames": frames, "w": w, "a": a},
           {"x0": (B * ho * wo, F), "frames": (B, S, H, W, Cin),
            "w": (K, F), "a": (F,)})
    route = mac_route(x0, frames, w)
    entry, counter = _MAC_ENTRY[route]
    shmem = _fn("stream_fold_mac_shmem_bytes")(S, Cin, F, k, stride,
                                               int(route == "tma"))
    if shmem > _MAX_SHARED_BYTES:
        raise ValueError(f"S {S}, Cin {Cin}, F {F}, k {k}: one block needs "
                         f"{shmem} B of shared memory, more than "
                         f"{_MAX_SHARED_BYTES}")
    pt, _ = same_pads(H, k, stride)
    pl, _ = same_pads(W, k, stride)
    out = torch.empty_like(x0)
    _launch(entry, counter, out, x0.data_ptr(),
            frames.data_ptr(), w.data_ptr(), a.data_ptr(), out.data_ptr(),
            B, S, H, W, Cin, ho, wo, F, k, stride, pt, pl, float(dv_unit))
    return out


def stream_fold(x0: torch.Tensor, deposits: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
    """Deposit-mode fold: the plain version on the CPU, the kernel on CUDA."""
    if _on_cpu(x0, deposits, a):
        return stream_fold_ref(x0, deposits, a)
    return stream_fold_cuda(x0, deposits, a)


def stream_fold_mac(x0: torch.Tensor, frames: torch.Tensor, w: torch.Tensor,
                    a: torch.Tensor, *, stride: int, dv_unit: float
                    ) -> torch.Tensor:
    """MAC-mode fold on event frames: the plain version on the CPU, the
    kernel on CUDA."""
    if _on_cpu(x0, frames, w, a):
        return stream_fold_mac_frames_ref(x0, frames, w, a, stride=stride,
                                          dv_unit=dv_unit)
    return stream_fold_mac_cuda(x0, frames, w, a, stride=stride,
                                dv_unit=dv_unit)
