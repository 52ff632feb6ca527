"""im2col for the in-pixel conv (``repro.kernels.p2m_conv.ops``); the P²M
conv kernel itself comes with the training slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.snn import same_pads


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
