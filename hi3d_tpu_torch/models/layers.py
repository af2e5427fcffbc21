"""UNet building blocks (counterpart of hi3d_tpu/models/layers.py).

NCHW / NCTHW layouts. Parameter names are the reference's torch names
(`in_layers.0`, `in_layers.2`, `emb_layers.1`, `out_layers.0`,
`out_layers.3`, `skip_connection`, `mix_factor`); the SiLU that follows each
GroupNorm is folded into `GroupNorm32(act="silu")`, so the Sequential slots
the reference fills with nn.SiLU hold nn.Identity and the indices stay put.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.group_norm import (
    group_moments,
    group_norm,
    group_norm_apply,
    group_norm_backward,
    group_stats,
    reads_in_place,
)


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """Sinusoidal embeddings [cos(t·f), sin(t·f)], f = exp(-log(P)·i/half), fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def zero_module(m: nn.Module) -> nn.Module:
    for p in m.parameters():
        nn.init.zeros_(p)
    return m


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) with fp32 statistics and apply, optional SiLU folded in,
    output in the input dtype; runs on K3 (ops.group_norm). At toy widths the
    group count is gcd(channels, 32), as in the JAX package."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__(math.gcd(num_channels, num_groups), num_channels, eps=eps)
        self.act = act

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """`shard` (a `parallel.dist.FrameShard`): x holds this rank's block
        of the locations and the groups span the ranks; the statistics are
        #9's moments of x, combined over the ranks, then K3 applies them
        (inference only)."""
        if shard is not None:
            if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad):
                raise NotImplementedError("the split GroupNorm is inference-only")
            x = x.contiguous()  # #9 reads a group as one contiguous run
            mean, m2 = group_moments(x, self.num_groups)
            stats = shard.combine_moments(mean, m2, x[0].numel() // self.num_groups, self.eps)
            return group_norm_apply(x, self.weight, self.bias, self.num_groups, stats, self.act)
        # K3 reads strided views such as the time stack's permuted input in
        # place; any other layout is made contiguous first
        if not reads_in_place(x):
            x = x.contiguous()
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.act)


def _folded_affine(x, weight, bias, num_groups, eps):
    """x·a + b with a = γ·inv_std, b = β − mean·a per (sample, channel), the
    statistics from #9 (ops.group_stats); fp32, cast to x's dtype."""
    n, c = x.shape[:2]
    mean, inv = group_stats(x, num_groups, eps)
    a = weight.float().view(1, num_groups, -1) * inv[:, :, None]
    b = bias.float().view(1, num_groups, -1) - mean[:, :, None] * a
    bshape = (n, c) + (1,) * (x.ndim - 2)
    return torch.addcmul(b.reshape(bshape), x, a.reshape(bshape)).to(x.dtype)


class _FoldedGroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps)
        return _folded_affine(x, weight, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        return (*group_norm_backward(x, weight, bias, dy, *ctx.args, act=None), None, None)


class FoldedGroupNorm(nn.GroupNorm):
    """GroupNorm whose statistics come from #9 and whose normalise-and-affine
    is one folded per-channel multiply-add (`torch.addcmul`), output in the
    input dtype. The VAE's norms (eps 1e-6) and the DPT backbone's
    GroupNormAct (eps 1e-5, ReLU after) run on it, both in fp32; the UNet's
    norms stay on K3 (GroupNorm32). When x, γ or β needs a gradient the
    backward is K3's plain fp32 `group_norm_backward` without activation."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()  # #9 reads a group as one contiguous run
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                        or self.bias.requires_grad):
            return _FoldedGroupNorm.apply(x, self.weight, self.bias, self.num_groups, self.eps)
        return _folded_affine(x, self.weight, self.bias, self.num_groups, self.eps)


class ResBlock(nn.Module):
    """GN→SiLU→conv, + timestep embedding, GN→SiLU→zero-conv, + skip.

    `dims=2` works on (N, C, H, W); `dims=3` on (B, C, T, H, W) with any
    kernel (the time stack uses (3, 1, 1)). With `exchange_temb_dims`, `emb`
    is (B, T, E) and is added per (B, C, T)."""

    def __init__(
        self,
        channels: int,
        emb_channels: int,
        out_channels: Optional[int] = None,
        dims: int = 2,
        kernel_size: Union[int, Sequence[int]] = 3,
        exchange_temb_dims: bool = False,
    ):
        super().__init__()
        out_channels = out_channels or channels
        kernel = (kernel_size,) * dims if isinstance(kernel_size, int) else tuple(kernel_size)
        pad = tuple(k // 2 for k in kernel)
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        self.exchange_temb_dims = exchange_temb_dims
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, act="silu"), nn.Identity(),
            conv(channels, out_channels, kernel, padding=pad),
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, act="silu"), nn.Identity(), nn.Identity(),
            zero_module(conv(out_channels, out_channels, kernel, padding=pad)),
        )
        self.skip_connection = (
            nn.Identity() if out_channels == channels
            else conv(channels, out_channels, 1)
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor, shard=None) -> torch.Tensor:
        """`shard`: the norms' groups span the ranks of a frame-parallel
        run (`GroupNorm32`)."""
        if shard is None:
            h = self.in_layers(x)
        else:
            h = self.in_layers[2](self.in_layers[0](x, shard))
        emb_out = self.emb_layers(emb).to(h.dtype)
        if self.exchange_temb_dims:
            emb_out = emb_out.transpose(1, 2)  # (B, T, C) → (B, C, T)
        emb_out = emb_out[(...,) + (None,) * (h.ndim - emb_out.ndim)]
        if shard is None:
            h = self.out_layers(h + emb_out)
        else:
            h = self.out_layers[3](self.out_layers[0](h + emb_out, shard))
        return self.skip_connection(x) + h


class Upsample(nn.Module):
    """Nearest ×2 upsample + 3×3 conv on (N, C, H, W)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 3×3 conv on (N, C, H, W)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.op = nn.Conv2d(channels, out_channels or channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class AlphaBlender(nn.Module):
    """alpha·x_spatial + (1 − alpha)·x_temporal with a learned sigmoid alpha;
    alpha is 1 for frames flagged image-only.

    `layout` says how the (B, T) alpha broadcasts: "video5d" over
    (B, T, C, H, W) tensors, "tokens3d" over (B·T, S, C) tokens."""

    def __init__(self, alpha: float = 0.5, merge_strategy: str = "learned_with_images",
                 layout: str = "video5d"):
        super().__init__()
        if merge_strategy not in ("learned", "learned_with_images"):
            raise ValueError(f"unported merge strategy {merge_strategy!r}")
        if layout not in ("video5d", "tokens3d"):
            raise ValueError(f"unknown AlphaBlender layout {layout!r}")
        self.merge_strategy = merge_strategy
        self.layout = layout
        self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))

    def forward(self, x_spatial, x_temporal, image_only_indicator=None):
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        if self.merge_strategy == "learned_with_images":
            if image_only_indicator is None:
                raise ValueError("learned_with_images needs image_only_indicator")
            alpha = torch.where(
                image_only_indicator.to(torch.bool), torch.ones((), device=alpha.device), alpha
            )
            if self.layout == "video5d":
                alpha = alpha[:, :, None, None, None]
            else:
                alpha = alpha.reshape(-1)[:, None, None]
        alpha = alpha.to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal
