"""Wrapper of the CUDA P²M conv kernel (``csrc/p2m_conv.cu``).

The counterpart of ``repro.kernels.p2m_conv.p2m_conv``'s
``p2m_conv_multi_pallas``, but reading the event frames instead of im2col
patches and writing the final [n_cfg, B, T, H', W', F] layout. The plain
version of the same function is ``ops.p2m_conv_events_ref``. Two
hand-written routes, chosen by shape (:func:`conv_route`): the dot
products on the tensor cores for the paper's 3×3 kernel over ON/OFF with
F % 8 == 0, W even and 16-byte-aligned events (counted as ``p2m_conv``),
FMA loops for any other k, Cin, F and W (counted as ``p2m_conv_fma``). ``LAUNCHES``
counts kernel launches, one per call that reached the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.snn import same_pads
from repro_torch.kernels import _build

LAUNCHES = {"p2m_conv": 0, "p2m_conv_fma": 0}
MAX_CONFIGS = 8             # the kernel's per-thread voltage registers
MAX_FILTERS = 64
_MAX_SHARED_BYTES = 232448  # what one block may opt in to on Hopper

_P, _I = ctypes.c_void_p, ctypes.c_int
_F32 = ctypes.c_float


def _lib():
    lib = _build.load("p2m_conv")
    for fn in (lib.p2m_conv_f32, lib.p2m_conv_fma_f32):
        fn.argtypes = ([_P] * 9 + [ctypes.c_longlong] + [_I] * 12
                       + [_F32] * 5 + [_I, _P])
        fn.restype = _I
    lib.p2m_conv_shmem_bytes.argtypes = [_I] * 7
    lib.p2m_conv_shmem_bytes.restype = ctypes.c_longlong
    lib.p2m_quotient_check.argtypes = [_F32, _F32, _P, _P]
    lib.p2m_quotient_check.restype = _I
    return lib


def conv_route(events: torch.Tensor, w: torch.Tensor, kernel_size: int
               ) -> str:
    """``"mma"`` (the tensor-core kernel) for k 3 over Cin 2 with F, w's
    last dimension, a multiple of 8, W even and the events 16-byte aligned
    (the rows its TMA loads read); ``"fma"`` otherwise."""
    mma = (kernel_size == 3 and events.shape[-1] == 2
           and w.shape[-1] % 8 == 0 and events.shape[-2] % 2 == 0
           and events.data_ptr() % 16 == 0)
    return "mma" if mma else "fma"


_ROUTE = {"mma": ("p2m_conv_f32", "p2m_conv"),
          "fma": ("p2m_conv_fma_f32", "p2m_conv_fma")}


def reciprocal(half_swing: float) -> float:
    """RN(1 / half_swing) in float32, the kernel's ``recip``: with it,
    Markstein's correction step gives the correctly rounded quotient."""
    return float(np.float32(1.0) / np.float32(half_swing))


def quotient_check(half_swing: float, device="cuda") -> int:
    """How many float32 v with |v| <= 1 (both signs, 2,130,706,434 values)
    have a kernel quotient v / half_swing that differs in any bit from
    ``__fdiv_rn``'s; one launch that allocates nothing per value and is
    not counted in ``LAUNCHES``."""
    count = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(count.device):
        stream = torch.cuda.current_stream(count.device).cuda_stream
        rc = _lib().p2m_quotient_check(half_swing, reciprocal(half_swing),
                                       count.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"p2m_quotient_check launch failed with "
                           f"cudaError {rc}")
    return int(count)


def _check(ts: dict[str, torch.Tensor], shapes: dict[str, tuple]) -> None:
    dev = ts["events"].device
    for name, t in ts.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every input must be "
                             f"on one CUDA device (events are on {dev})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def p2m_conv_cuda(events: torch.Tensor, w: torch.Tensor, v_inf: torch.Tensor,
                  decay: torch.Tensor, theta: torch.Tensor,
                  pv_gain: torch.Tensor, pv_offset: torch.Tensor, *,
                  kernel_size: int, stride: int, dv_unit: float,
                  half_swing: float, v_lo: float, v_hi: float,
                  nonlinear: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every config's P²M window integration in one launch, of the kernel
    :func:`conv_route` chooses for these inputs.

    events [B, T, n_sub, H, W, Cin] event counts; w [k·k·Cin, F] quantized
    weights (rows ordered kh, kw, Cin); v_inf/decay/theta [n_cfg, F];
    pv_gain/pv_offset [F]. SAME padding, ``stride`` 1 or more. Returns
    (spikes, v_pre), both float32 [n_cfg, B, T, H', W', F].
    """
    if events.dim() != 6 or w.dim() != 2 or v_inf.dim() != 2:
        raise ValueError(
            f"expected events [B, T, n_sub, H, W, Cin], w [K, F] and v_inf "
            f"[n_cfg, F], got {tuple(events.shape)}, {tuple(w.shape)} and "
            f"{tuple(v_inf.shape)}")
    B, T, n_sub, H, W, Cin = events.shape
    k = int(kernel_size)
    F = w.shape[1]
    n_cfg = v_inf.shape[0]
    if not 1 <= n_cfg <= MAX_CONFIGS:
        raise ValueError(f"the kernel takes 1 to {MAX_CONFIGS} configs, "
                         f"got {n_cfg}")
    if not 1 <= F <= MAX_FILTERS:
        raise ValueError(f"the kernel takes 1 to {MAX_FILTERS} filters, "
                         f"got {F}")
    if B * T * n_sub * H * W * Cin == 0 or k < 1 or stride < 1:
        raise ValueError("p2m_conv needs non-empty events, k >= 1 and "
                         "stride >= 1")
    per = {"v_inf": v_inf, "decay": decay, "theta": theta}
    _check({"events": events, "w": w, **per, "pv_gain": pv_gain,
            "pv_offset": pv_offset},
           {"events": tuple(events.shape), "w": (k * k * Cin, F),
            **{n: (n_cfg, F) for n in per}, "pv_gain": (F,),
            "pv_offset": (F,)})
    lib = _lib()
    route = conv_route(events, w, k)
    entry, counter = _ROUTE[route]
    shmem = lib.p2m_conv_shmem_bytes(n_sub, Cin, F, k, stride, n_cfg,
                                     int(route == "mma"))
    if shmem > _MAX_SHARED_BYTES:
        raise ValueError(f"n_sub {n_sub}, Cin {Cin}, F {F}, k {k}: one block "
                         f"needs {shmem} B of shared memory, more than "
                         f"{_MAX_SHARED_BYTES}")
    pt, _ = same_pads(H, k, stride)
    pl, _ = same_pads(W, k, stride)
    ho, wo = -(-H // stride), -(-W // stride)
    shape = (n_cfg, B, T, ho, wo, F)
    spikes = torch.empty(shape, device=events.device)
    v_pre = torch.empty(shape, device=events.device)
    with torch.cuda.device(events.device):
        stream = torch.cuda.current_stream(events.device).cuda_stream
        rc = getattr(lib, entry)(
            events.data_ptr(), w.data_ptr(), v_inf.data_ptr(),
            decay.data_ptr(), theta.data_ptr(), pv_gain.data_ptr(),
            pv_offset.data_ptr(), spikes.data_ptr(), v_pre.data_ptr(),
            B * T, n_sub, H, W, Cin, ho, wo, F, k, stride, pt, pl, n_cfg,
            dv_unit, half_swing, reciprocal(half_swing), v_lo, v_hi,
            int(bool(nonlinear)), stream)
    if rc:
        raise RuntimeError(f"{entry} launch failed with cudaError {rc}")
    LAUNCHES[counter] += 1
    return spikes, v_pre
