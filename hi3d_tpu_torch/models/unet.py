"""VideoUNet and the 2-D image UNetModel (counterparts of hi3d_tpu/models/unet.py).

x is (B·T, C_in, H, W); timesteps (B·T,); context (B or B·T, S_ctx, C_ctx);
y (B or B·T, adm_in_channels). Parameter names are the reference's
(`input_blocks.1.0.in_layers.0.weight`, `...time_stack...`,
`...time_mixer.mix_factor`, `time_embed.0`, `label_emb.0.0`, `out.2`), i.e.
what hi3d_tpu/convert/jax_to_torch.py emits.

Compute dtype: `dtype` (the engine passes its `compute_dtype`, as the JAX
engine passes `dtype=` to its flax UNet) is the dtype the layers compute in.
When the weights are in another dtype — fp32 master weights in training —
the forward runs under `torch.autocast` in `dtype`, so linears and convs run
in bf16 and the kernels see bf16 activations; norm statistics stay fp32.
With weights already in `dtype` (the inference cast) nothing is autocast.

`use_checkpoint` recomputes each VideoResBlock and SpatialVideoTransformer
(UNetModel: each ResBlock and SpatialTransformer) in the backward pass (`torch.utils.checkpoint`, non-reentrant), as the JAX UNet
wraps them in `nn.remat`; it only acts while gradients are recorded.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .layers import (
    AlphaBlender,
    Downsample,
    GroupNorm32,
    ResBlock,
    Upsample,
    timestep_embedding,
    zero_module,
)
from .attention import SpatialTransformer
from .video_attention import SpatialVideoTransformer


class VideoResBlock(ResBlock):
    """Spatial ResBlock, then a (3,1,1) time-stack ResBlock over
    (B, C, T, H, W), alpha-blended per (video, frame)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 video_kernel_size: Union[int, Sequence[int]] = (3, 1, 1),
                 merge_strategy: str = "learned_with_images", merge_factor: float = 0.5):
        super().__init__(channels, emb_channels, out_channels, dims=2)
        self.time_stack = ResBlock(out_channels, emb_channels, out_channels, dims=3,
                                   kernel_size=video_kernel_size, exchange_temb_dims=True)
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy, layout="video5d")

    def forward(self, x, emb, num_video_frames: int, image_only_indicator=None):
        x = super().forward(x, emb)
        bt, c, h, w = x.shape
        t = num_video_frames
        b = bt // t
        x5 = x.view(b, t, c, h, w)
        # the time stack takes the (B, C, T, H, W) view as it lies: its first
        # GroupNorm (K3) reads it in place and its skip add reads it too
        x_temporal = self.time_stack(
            x5.permute(0, 2, 1, 3, 4), emb.view(b, t, emb.shape[-1])
        )
        x5 = self.time_mixer(x5, x_temporal.permute(0, 2, 1, 3, 4), image_only_indicator)
        return x5.reshape(bt, c, h, w)


def _heads_for(ch: int, num_heads: int, num_head_channels: int) -> Tuple[int, int]:
    """(heads, channels a head) of a transformer on `ch` channels, as the
    JAX UNets' `_heads_for`: `num_head_channels` a head, or when that is
    -1, `num_heads` heads."""
    if num_head_channels == -1:
        return num_heads, ch // num_heads
    return ch // num_head_channels, num_head_channels


def _build_plan(model_channels: int, channel_mult: Sequence[int], num_res_blocks: int,
                attention_resolutions: Sequence[int], transformer_depth: Sequence[int]):
    """Static layer plan (input_blocks, middle, output_blocks), as in
    hi3d_tpu/models/unet.py:_build_plan: lists of ("conv_in", ch),
    ("res", out_ch), ("attn", ch, depth), ("down", ch), ("up", ch)."""
    input_blocks: List[List[Tuple]] = [[("conv_in", model_channels)]]
    ch = model_channels
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            ch = mult * model_channels
            layers: List[Tuple] = [("res", ch)]
            if ds in attention_resolutions:
                layers.append(("attn", ch, transformer_depth[level]))
            input_blocks.append(layers)
        if level != len(channel_mult) - 1:
            ds *= 2
            input_blocks.append([("down", ch)])
    middle = [("res", ch), ("attn", ch, transformer_depth[-1]), ("res", ch)]
    output_blocks: List[List[Tuple]] = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            ch = model_channels * mult
            layers = [("res", ch)]
            if ds in attention_resolutions:
                layers.append(("attn", ch, transformer_depth[level]))
            if level and i == num_res_blocks:
                ds //= 2
                layers.append(("up", ch))
            output_blocks.append(layers)
    return input_blocks, middle, output_blocks


class VideoUNet(nn.Module):
    """The stage-1 denoising network (config keys as in the reference YAML).

    Heads come from `num_head_channels` (channels a head) or, when that is
    -1, from `num_heads`. `use_linear_in_transformer`,
    `use_spatial_context` and `disable_temporal_crossattention` shape the
    SpatialVideoTransformers (models/video_attention.py); a forward without
    `use_spatial_context` takes the temporal context as `time_context`. `dropout` is accepted and
    inert: the JAX package's ResBlock dropout runs with
    `deterministic=True` on every call (hi3d_tpu/models/layers.py:268,350;
    no caller passes False)."""

    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        num_classes: Optional[str] = None,
        num_heads: int = -1,
        num_head_channels: int = -1,
        transformer_depth: Union[int, Sequence[int]] = 1,
        context_dim: Optional[int] = None,
        extra_ff_mix_layer: bool = False,
        use_spatial_context: bool = False,
        merge_strategy: str = "learned_with_images",
        merge_factor: float = 0.5,
        video_kernel_size: Union[int, Sequence[int]] = 3,
        use_linear_in_transformer: bool = False,
        adm_in_channels: Optional[int] = None,
        disable_temporal_crossattention: bool = False,
        max_ddpm_temb_period: int = 10000,
        use_checkpoint: bool = False,
        dropout: float = 0.0,
        spatial_transformer_attn_type: str = "softmax-xformers",  # YAML parity
        dtype: Optional[str] = None,
    ):
        super().__init__()
        if num_head_channels == -1 and num_heads == -1:
            raise ValueError("either num_heads or num_head_channels must be set")
        if num_classes not in (None, "sequential"):
            raise NotImplementedError(f"num_classes={num_classes!r} (Hi3D uses 'sequential')")
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.use_checkpoint = bool(use_checkpoint)
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.context_dim = context_dim
        self.adm_in_channels = adm_in_channels
        self.num_classes = num_classes
        depth = ([transformer_depth] * len(channel_mult) if isinstance(transformer_depth, int)
                 else list(transformer_depth))
        input_plan, middle_plan, output_plan = _build_plan(
            model_channels, channel_mult, num_res_blocks, attention_resolutions, depth
        )
        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, ted), nn.SiLU(), nn.Linear(ted, ted)
        )
        if num_classes == "sequential":
            self.label_emb = nn.Sequential(nn.Sequential(
                nn.Linear(adm_in_channels, ted), nn.SiLU(), nn.Linear(ted, ted)
            ))

        def make(spec, ch):
            kind = spec[0]
            if kind == "conv_in":
                return nn.Conv2d(in_channels, spec[1], 3, padding=1), spec[1]
            if kind == "res":
                return VideoResBlock(ch, ted, spec[1], video_kernel_size,
                                     merge_strategy, merge_factor), spec[1]
            if kind == "attn":
                return SpatialVideoTransformer(
                    ch, *_heads_for(ch, num_heads, num_head_channels), depth=spec[2],
                    context_dim=context_dim, ff_in=extra_ff_mix_layer,
                    merge_strategy=merge_strategy, merge_factor=merge_factor,
                    max_time_embed_period=max_ddpm_temb_period,
                    use_linear=use_linear_in_transformer,
                    use_spatial_context=use_spatial_context,
                    disable_temporal_crossattention=disable_temporal_crossattention,
                ), ch
            if kind == "down":
                return Downsample(ch), ch
            if kind == "up":
                return Upsample(ch), ch
            raise ValueError(kind)

        def make_block(plan, ch):
            layers = nn.ModuleList()
            for spec in plan:
                layer, ch = make(spec, ch)
                layers.append(layer)
            return layers, ch

        ch = in_channels
        skip_chans = []
        self.input_blocks = nn.ModuleList()
        for plan in input_plan:
            block, ch = make_block(plan, ch)
            self.input_blocks.append(block)
            skip_chans.append(ch)
        self.middle_block, ch = make_block(middle_plan, ch)
        self.output_blocks = nn.ModuleList()
        for plan in output_plan:
            block, ch = make_block(plan, ch + skip_chans.pop())
            self.output_blocks.append(block)
        self.out = nn.Sequential(
            GroupNorm32(ch, act="silu"), nn.Identity(),
            zero_module(nn.Conv2d(model_channels, out_channels, 3, padding=1)),
        )

    def _run(self, layers, h, emb, context, t, indicator, time_context=None):
        remat = self.use_checkpoint and torch.is_grad_enabled()
        for layer in layers:
            if isinstance(layer, VideoResBlock):
                args = (h, emb, t, indicator)
            elif isinstance(layer, SpatialVideoTransformer):
                args = (h, context, t, indicator, time_context)
            else:
                h = layer(h)
                continue
            h = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
        return h

    def forward(self, x, timesteps, context=None, y=None,
                num_video_frames: Optional[int] = None, image_only_indicator=None,
                encoder_cache: Optional[Tuple[Tuple[torch.Tensor, ...], torch.Tensor]] = None,
                return_encoder_cache: bool = False, time_context=None):
        """`encoder_cache` / `return_encoder_cache` serve encoder propagation
        (diffusion/encoder_reuse.py): a forward can return its (skip
        activations, middle h), and a forward given them skips the input and
        middle blocks and decodes from them. Exact when the cache comes from
        the same (x, timesteps)."""
        weight_dtype = self.time_embed[0].weight.dtype
        dtype = self.dtype or weight_dtype
        with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != weight_dtype):
            return self._forward(x, timesteps, context, y, num_video_frames,
                                 image_only_indicator, dtype, encoder_cache, return_encoder_cache,
                                 time_context)

    def _forward(self, x, timesteps, context, y, num_video_frames, image_only_indicator, dtype,
                 encoder_cache=None, return_encoder_cache=False, time_context=None):
        bt = x.shape[0]
        t = num_video_frames
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dtype))
        # per-video → per-frame broadcast (reference video_model.py:459-465)
        if y is not None and y.shape[0] != bt and bt // y.shape[0] == t:
            y = y.repeat_interleave(t, dim=0)
        if context is not None and context.shape[0] != bt and bt // context.shape[0] == t:
            context = context.repeat_interleave(t, dim=0)
        if context is not None:
            context = context.to(dtype)
        if time_context is not None:
            time_context = time_context.to(dtype)
        if self.num_classes is not None:
            emb = emb + self.label_emb(y.to(dtype))
        run = functools.partial(self._run, emb=emb, context=context, t=t,
                                indicator=image_only_indicator, time_context=time_context)
        if encoder_cache is None:
            h = x.to(dtype)
            skips = []
            for block in self.input_blocks:
                h = run(block, h)
                skips.append(h)
            h = run(self.middle_block, h)
        else:
            skips, h = encoder_cache
        cache = (tuple(skips), h)
        skips = list(skips)  # the decoder pops from a copy: `cache` stays whole
        for block in self.output_blocks:
            h = run(block, torch.cat([h, skips.pop()], dim=1))
        out = self.out(h)
        return (out, cache) if return_encoder_cache else out


class UNetModel(nn.Module):
    """The 2-D image UNet (reference openaimodel.UNetModel; the SD/SDXL
    denoiser family): VideoUNet's block plan with plain ResBlocks and
    SpatialTransformers and no temporal part. x is (B, C_in, H, W),
    timesteps (B,), context (B, S_ctx, context_dim), y (B,) class ids for
    an int `num_classes`, (B,) values for "continuous" and (B,
    adm_in_channels) for "sequential". Self-attention runs on K1 at every
    length; cross-attention against the context is plain
    (`ops.attention.cross_attention`), as the JAX package leaves it to XLA.
    Heads come from `num_head_channels` (channels a head) or `num_heads`;
    `use_linear_in_transformer` picks the transformers' projection layout.
    Compute dtype, `use_checkpoint` and the inert `dropout` work as in
    VideoUNet."""

    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        num_classes: Optional[Union[int, str]] = None,
        use_checkpoint: bool = False,
        num_heads: int = -1,
        num_head_channels: int = -1,
        transformer_depth: Union[int, Sequence[int]] = 1,
        context_dim: Optional[int] = None,
        use_linear_in_transformer: bool = False,
        adm_in_channels: Optional[int] = None,
        spatial_transformer_attn_type: str = "softmax-xformers",  # YAML parity
        dtype: Optional[str] = None,
    ):
        super().__init__()
        if num_head_channels == -1 and num_heads == -1:
            raise ValueError("either num_heads or num_head_channels must be set")
        if num_classes is not None and not isinstance(num_classes, int) and \
                num_classes not in ("sequential", "continuous"):
            raise NotImplementedError(f"num_classes={num_classes!r} unsupported")
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.use_checkpoint = bool(use_checkpoint)
        self.model_channels = model_channels
        self.num_classes = num_classes
        depth = ([transformer_depth] * len(channel_mult) if isinstance(transformer_depth, int)
                 else list(transformer_depth))
        input_plan, middle_plan, output_plan = _build_plan(
            model_channels, channel_mult, num_res_blocks, attention_resolutions, depth
        )
        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, ted), nn.SiLU(), nn.Linear(ted, ted)
        )
        if num_classes == "sequential":
            self.label_emb = nn.Sequential(nn.Sequential(
                nn.Linear(adm_in_channels, ted), nn.SiLU(), nn.Linear(ted, ted)
            ))
        elif num_classes == "continuous":
            self.label_emb = nn.Linear(1, ted)
        elif num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)

        def make(spec, ch):
            kind = spec[0]
            if kind == "conv_in":
                return nn.Conv2d(in_channels, spec[1], 3, padding=1), spec[1]
            if kind == "res":
                return ResBlock(ch, ted, spec[1]), spec[1]
            if kind == "attn":
                return SpatialTransformer(ch, *_heads_for(ch, num_heads, num_head_channels),
                                          depth=spec[2],
                                          context_dim=context_dim,
                                          use_linear=use_linear_in_transformer), ch
            if kind == "down":
                return Downsample(ch), ch
            if kind == "up":
                return Upsample(ch), ch
            raise ValueError(kind)

        def make_block(plan, ch):
            layers = nn.ModuleList()
            for spec in plan:
                layer, ch = make(spec, ch)
                layers.append(layer)
            return layers, ch

        ch = in_channels
        skip_chans = []
        self.input_blocks = nn.ModuleList()
        for plan in input_plan:
            block, ch = make_block(plan, ch)
            self.input_blocks.append(block)
            skip_chans.append(ch)
        self.middle_block, ch = make_block(middle_plan, ch)
        self.output_blocks = nn.ModuleList()
        for plan in output_plan:
            block, ch = make_block(plan, ch + skip_chans.pop())
            self.output_blocks.append(block)
        self.out = nn.Sequential(
            GroupNorm32(ch, act="silu"), nn.Identity(),
            zero_module(nn.Conv2d(model_channels, out_channels, 3, padding=1)),
        )

    def _run(self, layers, h, emb, context):
        remat = self.use_checkpoint and torch.is_grad_enabled()
        for layer in layers:
            if isinstance(layer, ResBlock):
                args = (h, emb)
            elif isinstance(layer, SpatialTransformer):
                args = (h, context)
            else:
                h = layer(h)
                continue
            h = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
        return h

    def forward(self, x, timesteps, context=None, y=None):
        weight_dtype = self.time_embed[0].weight.dtype
        dtype = self.dtype or weight_dtype
        with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != weight_dtype):
            emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dtype))
            if self.num_classes == "continuous":
                emb = emb + self.label_emb(y.to(dtype)[:, None])
            elif isinstance(self.num_classes, int):
                emb = emb + self.label_emb(y.long()).to(emb.dtype)
            elif self.num_classes is not None:
                emb = emb + self.label_emb(y.to(dtype))
            if context is not None:
                context = context.to(dtype)
            h = x.to(dtype)
            skips = []
            for block in self.input_blocks:
                h = self._run(block, h, emb, context)
                skips.append(h)
            h = self._run(self.middle_block, h, emb, context)
            for block in self.output_blocks:
                h = self._run(block, torch.cat([h, skips.pop()], dim=1), emb, context)
            return self.out(h)
