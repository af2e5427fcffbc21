"""Softmax splatting, a differentiable forward warp (counterpart of
hi3d_tpu/ops/softsplat.py:31-110).

Each source pixel moves along its flow vector and is scatter-added into the
four destination pixels around where it lands, with bilinear weights;
corners outside the image are dropped. The modes of the reference's
`softsplat` (tools/softmax_splatting/softsplat.py:10-46): "sum" is the raw
splat; "avg", "linear" and "soft" splat an extra normalisation channel (1,
the metric, exp(metric)) and divide by it, with the normaliser's zeros made
1 by default or by the `-addeps`, `-zeroeps` and `-clipeps` variants.

NCHW, as the reference: tenIn (B, C, H, W), tenFlow (B, 2, H, W) with
channel 0 the x (width) displacement, tenMetric (B, 1, H, W); the JAX
package is channels-last. The scatter is `Tensor.index_add` over the
pixels' rows in plain PyTorch and autograd gives the reference's hand-written `ingrad` (a gather
of the output gradient times the weights) and `flowgrad` (through the
weights' fractional terms; `floor` has zero gradient, as in the CUDA and JAX
versions). No kernel: the JAX package computes this in XLA, not in Pallas.

On the card the scatter-add runs on atomics, so the order in which the
contributions to one output pixel are summed changes from run to run: an
output of k contributions may differ between runs by up to about
(k - 1) · 2⁻²⁴ of the sum of their magnitudes in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

MODES = ("sum", "avg", "linear", "soft")


def splat_sum(ten_in: torch.Tensor, ten_flow: torch.Tensor) -> torch.Tensor:
    """The raw bilinear scatter-add forward warp of (B, C, H, W) by
    (B, 2, H, W)."""
    b, c, h, w = ten_in.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=ten_flow.dtype, device=ten_flow.device),
                            torch.arange(w, dtype=ten_flow.dtype, device=ten_flow.device),
                            indexing="ij")
    fx = gx + ten_flow[:, 0]
    fy = gy + ten_flow[:, 1]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    dx = fx - x0
    dy = fy - y0
    x0i = x0.long()
    y0i = y0.long()

    # rows of (B·(H·W + 1), C): a video's H·W pixels, then the sink of its
    # out-of-bounds corners
    base = (torch.arange(b, device=ten_in.device) * (h * w + 1))[:, None]
    vals = ten_in.reshape(b, c, h * w).permute(0, 2, 1)
    out = ten_in.new_zeros((b * (h * w + 1), c))
    for ox, oy, wgt in ((0, 0, (1.0 - dx) * (1.0 - dy)), (1, 0, dx * (1.0 - dy)),
                        (0, 1, (1.0 - dx) * dy), (1, 1, dx * dy)):
        xi = x0i + ox
        yi = y0i + oy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = torch.where(valid, yi * w + xi, h * w).reshape(b, h * w) + base
        out = out.index_add(0, flat.reshape(-1), (vals * wgt.reshape(b, h * w, 1).to(
            ten_in.dtype)).reshape(b * h * w, c))
    return out.view(b, h * w + 1, c)[:, :h * w].permute(0, 2, 1).reshape(b, c, h, w)


def softsplat(tenIn: torch.Tensor, tenFlow: torch.Tensor, tenMetric: Optional[torch.Tensor],
              strMode: str) -> torch.Tensor:
    """The reference's `softsplat(tenIn, tenFlow, tenMetric, strMode)`;
    `strMode` is a mode of MODES, optionally with "-addeps", "-zeroeps" or
    "-clipeps"."""
    mode, _, param = strMode.partition("-")
    if mode not in MODES:
        raise ValueError(f"unknown splat mode {strMode!r}")
    if mode in ("sum", "avg"):
        if tenMetric is not None:
            raise ValueError(f"{mode} takes no metric")
    elif tenMetric is None or tenMetric.shape[1] != 1:
        raise ValueError(f"{mode} needs a (B, 1, H, W) metric")

    if mode == "avg":
        tenIn = torch.cat([tenIn, tenIn.new_ones((tenIn.shape[0], 1, *tenIn.shape[2:]))], 1)
    elif mode == "linear":
        tenIn = torch.cat([tenIn * tenMetric, tenMetric], 1)
    elif mode == "soft":
        e = torch.exp(tenMetric)
        tenIn = torch.cat([tenIn * e, e], 1)

    out = splat_sum(tenIn, tenFlow)
    if mode == "sum":
        return out
    norm = out[:, -1:]
    if param == "addeps":
        norm = norm + 1e-7
    elif param == "clipeps":
        norm = torch.where(norm.abs() < 1e-7, torch.sign(norm) * 1e-7 + (norm == 0.0), norm)
    else:  # the default and "zeroeps": zeros → 1
        norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return out[:, :-1] / norm
