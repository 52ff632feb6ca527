"""The P²M conv as the model calls it (``repro.kernels.p2m_conv.ops`` in
PyTorch): events → per-config leak legs and thresholds → the kernel →
spike maps.

``p2m_conv(params, events, cfg)`` is the ``mode="kernel"`` counterpart of
``core.p2m_layer.p2m_forward_scan``; ``p2m_conv_multi`` evaluates the same
events under several circuit configs in one launch. The device decides the
route: on CUDA tensors the hand-written kernel, which reads the event
frames itself; on the CPU im2col and the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import analog, leakage
from repro_torch.core.snn import same_pads
from repro_torch.kernels.p2m_conv.p2m_conv import p2m_conv_cuda
from repro_torch.kernels.p2m_conv.ref import p2m_conv_multi_ref


def _extract_patches(frames: torch.Tensor, k: int, stride: int
                     ) -> tuple[torch.Tensor, tuple[int, int]]:
    """frames [N, H, W, C] → patches [N, H'·W', k·k·C] with the patch axis
    ordered (kh, kw, C) like HWIO weights, SAME padding; and (H', W')."""
    N, H, W, C = frames.shape
    pt, pb = same_pads(H, k, stride)
    pl, pr = same_pads(W, k, stride)
    x = F.pad(frames.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    cols = F.unfold(x, k, stride=stride)                # [N, C·k·k, L]
    ho = (H + pt + pb - k) // stride + 1
    wo = (W + pl + pr - k) // stride + 1
    cols = cols.reshape(N, C, k, k, ho * wo).permute(0, 4, 2, 3, 1)
    return cols.reshape(N, ho * wo, k * k * C), (ho, wo)


def p2m_conv_events_ref(events: torch.Tensor, w: torch.Tensor,
                        v_inf: torch.Tensor, decay: torch.Tensor,
                        theta: torch.Tensor, pv_gain: torch.Tensor,
                        pv_offset: torch.Tensor, *, kernel_size: int,
                        stride: int, **consts
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`~repro_torch.kernels.p2m_conv.p2m_conv.
    p2m_conv_cuda`, same arguments and result: im2col into patches
    [T, n_sub, B·H'·W', K], :func:`p2m_conv_multi_ref`, and the result
    reshaped to [n_cfg, B, T, H', W', F]."""
    B, T, n_sub, H, W, Cin = events.shape
    k = kernel_size
    patches, (ho, wo) = _extract_patches(
        events.reshape(B * T * n_sub, H, W, Cin), k, stride)
    patches = patches.reshape(B, T, n_sub, ho * wo, k * k * Cin)
    patches = patches.permute(1, 2, 0, 3, 4).reshape(T, n_sub, B * ho * wo,
                                                    k * k * Cin)
    spikes, v_pre = p2m_conv_multi_ref(patches, w, v_inf, decay, theta,
                                       pv_gain, pv_offset, **consts)

    def back(x):
        return x.reshape(x.shape[0], T, B, ho, wo, x.shape[-1]).transpose(1, 2)
    return back(spikes), back(v_pre)


def _prepare(params: dict, cfg, leak_cfgs: tuple) -> tuple:
    """Quantized weights as [K, F], the stacked leak legs and comparator
    thresholds [n_cfg, F] (each variant may override ``cfg.v_threshold``),
    and the analog constants the kernel takes."""
    w_q = analog.quantize_weights(params["w"], cfg.analog)   # [k,k,Cin,F]
    lk = leakage.stacked_leak_params(w_q, leak_cfgs)
    theta = torch.tensor([leakage.resolve_v_threshold(lc, cfg.v_threshold)
                          for lc in leak_cfgs], dtype=torch.float32,
                         device=w_q.device)[:, None].expand_as(lk.v_inf)
    decay = leakage.decay_factor(lk.tau_ms, cfg.dt_ms)
    a = cfg.analog
    consts = dict(kernel_size=cfg.kernel_size, stride=cfg.stride,
                  dv_unit=a.dv_unit, half_swing=a.vdd / 2.0,
                  v_lo=-a.v_precharge, v_hi=a.vdd - a.v_precharge,
                  nonlinear=a.enable_nonlinearity)
    w2 = w_q.reshape(-1, cfg.out_channels)
    return (w2.contiguous(), lk.v_inf.contiguous(), decay.contiguous(),
            theta.contiguous(), consts)


def p2m_conv_multi(params: dict, events: torch.Tensor, cfg,
                   leak_cfgs: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """events [B, T, n_sub, H, W, Cin] under every config of ``leak_cfgs``
    → (spikes, v_pre), both [n_cfg, B, T, H', W', F] float32."""
    w2, v_inf, decay, theta, consts = _prepare(params, cfg, leak_cfgs)
    fn = p2m_conv_events_ref if events.device.type == "cpu" else p2m_conv_cuda
    return fn(events, w2, v_inf, decay, theta, params["pv_gain"],
              params["pv_offset"], **consts)


def p2m_conv(params: dict, events: torch.Tensor, cfg
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """events [B, T, n_sub, H, W, Cin] → (spikes, v_pre) [B, T, H', W', F]
    under ``cfg.leak``."""
    spikes, v_pre = p2m_conv_multi(params, events, cfg, (cfg.leak,))
    return spikes[0], v_pre[0]
