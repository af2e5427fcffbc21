"""FlowNet-style cost-volume correlation (counterpart of
hi3d_tpu/ops/correlation.py:26-55).

The reference's `FunctionCorrelation` (tools/softmax_splatting/correlation/
correlation.py) is a fixed max_displacement = 4, kernel-size-1, stride-1
correlation of two NCHW feature maps: 81 output channels, channel
`(dy+4)·9 + (dx+4)` holding the channel mean of one[:, :, y, x] ·
two[:, :, y+dy, x+dx], zero outside the image. It is used only by the
reference's PWC-Net `Flow` network.

The port takes NCHW, as the reference does (the JAX package is
channels-last), and computes the 81 shifted products in plain PyTorch;
autograd gives the backward. No kernel: the JAX package computes this in
XLA, not in Pallas.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

MAX_DISPLACEMENT = 4
_TAPS = 2 * MAX_DISPLACEMENT + 1  # 9 per axis → 81 channels


def correlation(one: torch.Tensor, two: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) × (B, C, H, W) → (B, 81, H, W) cost volume."""
    if one.shape != two.shape:
        raise ValueError(f"shape mismatch {tuple(one.shape)} vs {tuple(two.shape)}")
    _, _, h, w = one.shape
    d = MAX_DISPLACEMENT
    pad = F.pad(two, (d, d, d, d))
    return torch.stack([(one * pad[:, :, dy:dy + h, dx:dx + w]).mean(dim=1)
                        for dy in range(_TAPS) for dx in range(_TAPS)], dim=1)


class ModuleCorrelation(nn.Module):
    """The reference's module wrapper (correlation.py:387-393)."""

    def forward(self, one: torch.Tensor, two: torch.Tensor) -> torch.Tensor:
        return correlation(one, two)


FunctionCorrelation = correlation  # the reference's autograd.Function entry name
