"""Temporal transformer stack (counterpart of hi3d_tpu/models/video_attention.py).

Only the JAX package's default "4d" token layout is ported: the temporal
blocks keep tokens as (B, T, S, C) and attend over the frame axis in place
(K2), with per-video context that is not repeated per location.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .attention import BasicTransformerBlock, FeedForward, LayerNorm32, TimeAxisCrossAttention
from .layers import AlphaBlender, GroupNorm32, timestep_embedding, zero_module


class VideoTransformerBlock(nn.Module):
    """Temporal block on (B·T, S, C) tokens: ff_in, frame self-attention,
    frame cross-attention against per-video context, FF; all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 ff_in: bool = True):
        super().__init__()
        if ff_in:
            self.norm_in = LayerNorm32(dim)
            self.ff_in = FeedForward(dim, dim_out=dim)
        self.has_ff_in = ff_in
        self.attn1 = TimeAxisCrossAttention(dim, None, heads, dim_head)
        self.norm1 = LayerNorm32(dim)
        self.attn2 = TimeAxisCrossAttention(dim, context_dim, heads, dim_head)
        self.norm2 = LayerNorm32(dim)
        self.ff = FeedForward(dim)
        self.norm3 = LayerNorm32(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                timesteps: int = 1) -> torch.Tensor:
        bt, s, c = x.shape
        x = x.view(bt // timesteps, timesteps, s, c)
        if self.has_ff_in:
            x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        x = self.ff(self.norm3(x)) + x
        return x.reshape(bt, s, c)


class SpatialVideoTransformer(nn.Module):
    """Spatial transformer blocks interleaved with temporal blocks on
    (B·T, C, H, W), with a learned frame-position embedding and an
    alpha-blend of the two streams. `context` is per frame (B·T, S, C_ctx);
    the temporal blocks attend to each video's first-frame context (the
    reference's `use_spatial_context`, which both Hi3D configs set)."""

    def __init__(
        self,
        in_channels: int,
        heads: int,
        dim_head: int,
        depth: int = 1,
        context_dim: Optional[int] = None,
        ff_in: bool = True,
        merge_strategy: str = "learned_with_images",
        merge_factor: float = 0.5,
        max_time_embed_period: int = 10000,
    ):
        super().__init__()
        inner = heads * dim_head
        self.max_time_embed_period = max_time_embed_period
        self.norm = GroupNorm32(in_channels)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)
        )
        self.time_stack = nn.ModuleList(
            VideoTransformerBlock(inner, heads, dim_head, context_dim, ff_in=ff_in)
            for _ in range(depth)
        )
        self.time_pos_embed = nn.Sequential(
            nn.Linear(in_channels, in_channels * 4), nn.SiLU(),
            nn.Linear(in_channels * 4, in_channels),
        )
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy, layout="tokens3d")
        self.proj_out = zero_module(nn.Linear(inner, in_channels))

    def forward(self, x, context, timesteps: int, image_only_indicator=None):
        bt, c, h, w = x.shape
        t = timesteps
        b = bt // t
        x_in = x
        time_context = context.view(b, t, *context.shape[1:])[:, 0]

        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(bt, h * w, c)
        tokens = self.proj_in(tokens)
        frame_idx = torch.arange(t, dtype=torch.float32, device=x.device).repeat(b)
        t_emb = timestep_embedding(frame_idx, c, max_period=self.max_time_embed_period)
        emb = self.time_pos_embed(t_emb.to(self.proj_in.weight.dtype))[:, None, :]

        for block, mix_block in zip(self.transformer_blocks, self.time_stack):
            tokens = block(tokens, context=context)
            mix = mix_block(tokens + emb.to(tokens.dtype), context=time_context, timesteps=t)
            tokens = self.time_mixer(tokens, mix, image_only_indicator)

        tokens = self.proj_out(tokens)
        # x_in first: the sum takes the first operand's memory order, so the
        # block's output stays contiguous NCHW (not the tokens' channels-last
        # order) and the ResBlock after it, its norms and its time stack's
        # (B, C, T, H, W) view, read it without a copy
        return x_in + tokens.reshape(bt, h, w, c).permute(0, 3, 1, 2)
