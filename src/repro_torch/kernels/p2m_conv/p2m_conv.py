"""Wrapper of the CUDA P²M conv kernel (``csrc/p2m_conv.cu``).

The counterpart of ``repro.kernels.p2m_conv.p2m_conv``'s
``p2m_conv_multi_pallas``, but reading the event frames instead of im2col
patches and writing the final [n_cfg, B, T, H', W', F] layout. ``LAUNCHES``
counts kernel launches, one per call that reached the card. The plain
version of the same function is ``ops.p2m_conv_events_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.snn import same_pads
from repro_torch.kernels import _build

LAUNCHES = {"p2m_conv": 0}
MAX_CONFIGS = 8             # the kernel's per-thread voltage registers
MAX_FILTERS = 64            # 16 threads per filter, 1024 per block
_MAX_SHARED_BYTES = 48 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_F32 = ctypes.c_float


def _lib():
    lib = _build.load("p2m_conv")
    lib.p2m_conv_f32.argtypes = ([_P] * 9 + [ctypes.c_longlong] + [_I] * 12
                                 + [_F32] * 4 + [_I, _P])
    lib.p2m_conv_f32.restype = _I
    lib.p2m_conv_shmem_bytes.argtypes = [_I] * 6
    lib.p2m_conv_shmem_bytes.restype = ctypes.c_longlong
    return lib


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
    """Every config's P²M window integration in one launch.

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
    shmem = lib.p2m_conv_shmem_bytes(n_sub, Cin, F, k, stride, n_cfg)
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
        rc = lib.p2m_conv_f32(
            events.data_ptr(), w.data_ptr(), v_inf.data_ptr(),
            decay.data_ptr(), theta.data_ptr(), pv_gain.data_ptr(),
            pv_offset.data_ptr(), spikes.data_ptr(), v_pre.data_ptr(),
            B * T, n_sub, H, W, Cin, ho, wo, F, k, stride, pt, pl, n_cfg,
            dv_unit, half_swing, v_lo, v_hi, int(bool(nonlinear)), stream)
    if rc:
        raise RuntimeError(f"p2m_conv_f32 launch failed with cudaError {rc}")
    LAUNCHES["p2m_conv"] += 1
    return spikes, v_pre
