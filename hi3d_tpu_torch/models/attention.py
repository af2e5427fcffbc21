"""Transformer blocks of the UNet (counterpart of hi3d_tpu/models/attention.py).

Token tensors are (N, S, C). LayerNorms run on #10 (fp32 statistics and
apply in one pass, output in the input dtype); GELU is exact (erf).
Parameter names follow the reference: `to_q`, `to_k`, `to_v`, `to_out.0`,
`ff.net.0.proj`, `ff.net.2`, `norm1..3`, `proj_in`, `proj_out`, `norm`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention as attn_ops
from ..ops.layer_norm import layer_norm
from .layers import GroupNorm32, zero_module


class LayerNorm32(nn.LayerNorm):
    """LayerNorm over the last dim with fp32 statistics and apply, output in
    the input dtype, on #10 (ops.layer_norm). Every LayerNorm of the port
    runs here: the UNet's transformer blocks, the CLIP towers (eps 1e-5)
    and the DPT's ViT (eps 1e-6)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class CrossAttention(nn.Module):
    """Multi-head attention on (B, S, C) tokens; self-attention (K1) when
    `context` is None, else against the (B, S_ctx, C_ctx) context."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        ctx = x if context is None else context
        sk = ctx.shape[1]
        q = self.to_q(x).view(b, s, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, sk, self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, sk, self.heads, self.dim_head)
        if context is None:
            out = attn_ops.self_attention(q, k, v)
        else:
            out = attn_ops.cross_attention(q, k, v)
        return self.to_out(out.reshape(b, s, self.heads * self.dim_head))


class TimeAxisCrossAttention(CrossAttention):
    """Attention along the frame axis of (B, T, S, C) tokens: self-attention
    (K2) when `context` is None, else against per-video (B, S_ctx, C_ctx)
    context that is not repeated per location. Same parameters as
    CrossAttention."""

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, s, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).view(b, t, s, h, d)
        if context is None:
            k = self.to_k(x).view(b, t, s, h, d)
            v = self.to_v(x).view(b, t, s, h, d)
            out = attn_ops.time_self_attention(q, k, v)
        else:
            sk = context.shape[1]
            k = self.to_k(context).view(b, sk, h, d)
            v = self.to_v(context).view(b, sk, h, d)
            out = attn_ops.time_cross_attention(q, k, v)
        return self.to_out(out.reshape(b, t, s, h * d))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU MLP: dim → mult·dim → dim_out."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim_out or dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """self-attn → cross-attn(context) → GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.norm3 = LayerNorm32(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm → proj_in → transformer blocks over H·W tokens → zero-init
    proj_out → residual, on (N, C, H, W). `use_linear` (the Hi3D configs')
    projects the tokens with Linear layers; otherwise proj_in and proj_out
    are 1×1 convolutions on the image, before and after the token view
    (the JAX package's `use_linear=False`), under the same names."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, use_linear: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.use_linear = use_linear
        self.norm = GroupNorm32(in_channels)
        self.proj_in = (nn.Linear(in_channels, inner) if use_linear
                        else nn.Conv2d(in_channels, inner, 1))
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)
        )
        self.proj_out = zero_module(nn.Linear(inner, in_channels) if use_linear
                                    else nn.Conv2d(inner, in_channels, 1))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.norm(x)
        if self.use_linear:
            tokens = self.proj_in(y.permute(0, 2, 3, 1).reshape(n, h * w, c))
        else:
            y = self.proj_in(y)
            tokens = y.permute(0, 2, 3, 1).reshape(n, h * w, y.shape[1])
        for block in self.transformer_blocks:
            tokens = block(tokens, context=context)
        if self.use_linear:
            y = self.proj_out(tokens).reshape(n, h, w, c).permute(0, 3, 1, 2)
        else:
            y = self.proj_out(tokens.reshape(n, h, w, -1).permute(0, 3, 1, 2))
        return y + x
