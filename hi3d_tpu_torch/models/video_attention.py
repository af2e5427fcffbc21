"""Temporal transformer stack (counterpart of hi3d_tpu/models/video_attention.py).

Only the JAX package's default "4d" token layout is ported: the temporal
blocks keep tokens as (B, T, S, C) and attend over the frame axis in place
(K2), with per-video context that is not repeated per location.

The temporal cross-attention (`attn2`) attends to, in the JAX package's
order (video_attention.py:195-215): the first frame's spatial context of
each video when `use_spatial_context` (the Hi3D configs); else the
`time_context` the UNet's caller passes, (B, S, C) or (B, C); else nothing,
so that `attn2` is a second frame self-attention (a second K2 or #6 launch
at the site). `disable_temporal_crossattention` drops `attn2` and `norm2`.
`attn2`'s key and value projections take `context_dim` channels under
`use_spatial_context`, else the block's own width, as the reference's
SpatialVideoTransformer builds them (its temporal `context_dim` is None
there): a `time_context` is as wide as the block. flax sizes them from the
first call's context, so the JAX package also takes other widths, for
which no reference checkpoint has weights.
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
                 ff_in: bool = True, disable_temporal_crossattention: bool = False):
        super().__init__()
        if ff_in:
            self.norm_in = LayerNorm32(dim)
            self.ff_in = FeedForward(dim, dim_out=dim)
        self.has_ff_in = ff_in
        self.attn1 = TimeAxisCrossAttention(dim, None, heads, dim_head)
        self.norm1 = LayerNorm32(dim)
        self.has_attn2 = not disable_temporal_crossattention
        if self.has_attn2:
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
        if self.has_attn2:
            x = self.attn2(self.norm2(x), context=context) + x
        x = self.ff(self.norm3(x)) + x
        return x.reshape(bt, s, c)


class SpatialVideoTransformer(nn.Module):
    """Spatial transformer blocks interleaved with temporal blocks on
    (B·T, C, H, W), with a learned frame-position embedding and an
    alpha-blend of the two streams. `context` is per frame (B·T, S, C_ctx);
    the temporal blocks' context is as the module docstring says.
    `use_linear` projects the tokens with Linear layers; otherwise proj_in
    and proj_out are 1×1 convolutions on the image, under the same names."""

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
        use_linear: bool = True,
        use_spatial_context: bool = True,
        disable_temporal_crossattention: bool = False,
    ):
        super().__init__()
        inner = heads * dim_head
        self.max_time_embed_period = max_time_embed_period
        self.use_linear = use_linear
        self.use_spatial_context = use_spatial_context
        self.norm = GroupNorm32(in_channels)
        self.proj_in = (nn.Linear(in_channels, inner) if use_linear
                        else nn.Conv2d(in_channels, inner, 1))
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)
        )
        temporal_context_dim = context_dim if use_spatial_context else None
        self.time_stack = nn.ModuleList(
            VideoTransformerBlock(inner, heads, dim_head, temporal_context_dim, ff_in=ff_in,
                                  disable_temporal_crossattention=disable_temporal_crossattention)
            for _ in range(depth)
        )
        self.time_pos_embed = nn.Sequential(
            nn.Linear(in_channels, in_channels * 4), nn.SiLU(),
            nn.Linear(in_channels * 4, in_channels),
        )
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy, layout="tokens3d")
        self.proj_out = zero_module(nn.Linear(inner, in_channels) if use_linear
                                    else nn.Conv2d(inner, in_channels, 1))

    def frame_self_attentions(self, time_context: bool = False) -> int:
        """Frame-axis self-attentions one forward runs (K2 or #6 launches
        on the card): `attn1` of each temporal block, and `attn2` where it
        attends with no context (no spatial context and, as `time_context`
        says, no time_context)."""
        own = not self.use_spatial_context and not time_context
        return sum(1 + (block.has_attn2 and own) for block in self.time_stack)

    def forward(self, x, context, timesteps: int, image_only_indicator=None, time_context=None,
                shard=None, video_context=None):
        """`shard` (frame-parallel, a `parallel.dist.FrameShard`): x,
        `context` and the indicator ((1, rows)) are this rank's rows,
        `video_context` the per-video context; each temporal block runs on
        every frame of this rank's block of the locations."""
        bt, c, h, w = x.shape
        t = timesteps
        b = bt // t
        x_in = x
        if shard is not None and self.use_spatial_context:
            time_context = video_context  # each video's context, as its first frame has it
        elif self.use_spatial_context:
            time_context = context.view(b, t, *context.shape[1:])[:, 0]
        if time_context is not None and time_context.ndim == 2:
            time_context = time_context[:, None, :]

        y = self.norm(x)
        if self.use_linear:
            tokens = self.proj_in(y.permute(0, 2, 3, 1).reshape(bt, h * w, c))
        else:
            y = self.proj_in(y)
            tokens = y.permute(0, 2, 3, 1).reshape(bt, h * w, y.shape[1])
        if shard is None:
            frame_idx = torch.arange(t, dtype=torch.float32, device=x.device).repeat(b)
        else:
            frame_idx = shard.frame_index(shard.copies(bt), x.device).float()
        t_emb = timestep_embedding(frame_idx, c, max_period=self.max_time_embed_period)
        emb = self.time_pos_embed(t_emb.to(self.proj_in.weight.dtype))[:, None, :]

        for block, mix_block in zip(self.transformer_blocks, self.time_stack):
            tokens = block(tokens, context=context)
            mix = tokens + emb.to(tokens.dtype)
            if shard is None:
                mix = mix_block(mix, context=time_context, timesteps=t)
            else:  # all the frames of this rank's block of the locations
                mix = shard.to_frames(mix_block(shard.to_locations(mix, 1),
                                                context=time_context, timesteps=t), 1, h * w)
            tokens = self.time_mixer(tokens, mix, image_only_indicator)

        if self.use_linear:
            y = self.proj_out(tokens).reshape(bt, h, w, c).permute(0, 3, 1, 2)
        else:
            y = self.proj_out(tokens.reshape(bt, h, w, -1).permute(0, 3, 1, 2))
        # x_in first: the sum takes the first operand's memory order, so the
        # block's output stays contiguous NCHW (not the tokens' channels-last
        # order) and the ResBlock after it, its norms and its time stack's
        # (B, C, T, H, W) view, read it without a copy
        return x_in + y
