"""SVD's temporal VAE decoder (counterpart of hi3d_tpu/models/temporal_ae.py).

The 2-D `vae.Decoder` with its blocks swapped per `time_mode`:
- "conv-only" (SVD's released image decoder): every ResnetBlock becomes a
  `VideoResBlock` (the spatial block, then an embedding-free 3-D `time_stack`
  ResBlock over (T, H, W) with kernel `video_kernel_size`, merged as
  α·temporal + (1 − α)·spatial, α = σ(mix_factor): the weight is on the
  *temporal* branch) and conv_out becomes an `AE3DConv` (the 3×3 conv, then
  a 3-D `time_mix_conv`);
- "attn-only": the attention blocks become `VideoAttnBlock`s (the spatial
  single-head attention, a frame-position MLP and a one-head
  `VideoTransformerBlock` of head dim C across the frames, α-merged, then
  proj_out); the ResnetBlocks and conv_out stay 2-D;
- "all": both.

Frames are (B·T, C, H, W) with `timesteps` = T. The time stack runs on the
(B, C, T, H, W) view, copied to contiguous memory for #9. Every GroupNorm is
a `FoldedGroupNorm` at eps 1e-6 (#9), the time stack's too, as the JAX
package's `VaeGroupNorm`. `VideoAttnBlock`'s LayerNorms are the port's #10;
its frame attention has head dim C (512 in SVD's mid block, fp32), past
the kernels' 256, so `ops.attention.frame_attention_kernel` sends it to the
plain path, as the JAX package sends it to plain einsums. Parameter names are the reference's
(`time_stack.in_layers.0`, `mix_factor`, `conv_out.time_mix_conv`,
`time_mix_block.*`, `video_time_embed.0`).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn

from .layers import timestep_embedding, zero_module
from .vae import AttnBlock, Decoder, ResnetBlock, _norm
from .video_attention import VideoTransformerBlock

TIME_MODES = ("all", "conv-only", "attn-only")


def _triple(k: Union[int, Sequence[int]]):
    return (k, k, k) if isinstance(k, int) else tuple(k)


def _to_video(x: torch.Tensor, t: int) -> torch.Tensor:
    """(B·T, C, H, W) → contiguous (B, C, T, H, W)."""
    bt, c, h, w = x.shape
    return x.view(bt // t, t, c, h, w).transpose(1, 2).contiguous()


def _to_frames(x5: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) → contiguous (B·T, C, H, W)."""
    b, c, t, h, w = x5.shape
    return x5.transpose(1, 2).reshape(b * t, c, h, w)


class _Mixer:
    """The merge weight α of a video block: σ(mix_factor) for the "learned"
    strategy (a parameter), the buffer itself for "fixed"."""

    def _init_mix(self, alpha: float, merge_strategy: str) -> None:
        value = torch.tensor([float(alpha)])
        if merge_strategy == "fixed":
            self.register_buffer("mix_factor", value)
        elif merge_strategy == "learned":
            self.mix_factor = nn.Parameter(value)
        else:
            raise ValueError(f"unknown merge strategy {merge_strategy!r}")
        self.merge_strategy = merge_strategy

    def alpha(self) -> torch.Tensor:
        if self.merge_strategy == "fixed":
            return self.mix_factor
        return torch.sigmoid(self.mix_factor)


class TimeStack3D(nn.Module):
    """Embedding-free 3-D ResBlock on (B, C, T, H, W): norm → SiLU → conv,
    norm → SiLU → zero-initialised conv, plus the input (the reference's
    openaimodel ResBlock with skip_t_emb)."""

    def __init__(self, channels: int, kernel: Union[int, Sequence[int]] = 3):
        super().__init__()
        k = _triple(kernel)
        pad = tuple(d // 2 for d in k)
        self.in_layers = nn.Sequential(_norm(channels), nn.SiLU(),
                                       nn.Conv3d(channels, channels, k, padding=pad))
        self.out_layers = nn.Sequential(
            _norm(channels), nn.SiLU(), nn.Identity(),
            zero_module(nn.Conv3d(channels, channels, k, padding=pad)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.out_layers(self.in_layers(x))


class VideoResBlock(_Mixer, ResnetBlock):
    """The VAE ResnetBlock, then its `time_stack` across the frames,
    α-merged with α on the temporal branch."""

    def __init__(self, in_channels: int, out_channels: int,
                 video_kernel_size: Union[int, Sequence[int]] = 3, alpha: float = 0.0,
                 merge_strategy: str = "learned"):
        super().__init__(in_channels, out_channels)
        self.time_stack = TimeStack3D(out_channels, video_kernel_size)
        self._init_mix(alpha, merge_strategy)

    def forward(self, x: torch.Tensor, timesteps: int, skip_video: bool = False) -> torch.Tensor:
        x = super().forward(x)
        if skip_video:
            return x
        x5 = _to_video(x, timesteps)
        alpha = self.alpha().to(x.dtype)
        return _to_frames(alpha * self.time_stack(x5) + (1.0 - alpha) * x5)


class AE3DConv(nn.Conv2d):
    """3×3 conv, then a 3-D `time_mix_conv` over (T, H, W)."""

    def __init__(self, in_channels: int, out_channels: int,
                 video_kernel_size: Union[int, Sequence[int]] = 3):
        super().__init__(in_channels, out_channels, 3, padding=1)
        k = _triple(video_kernel_size)
        self.time_mix_conv = nn.Conv3d(out_channels, out_channels, k,
                                       padding=tuple(d // 2 for d in k))

    def forward(self, x: torch.Tensor, timesteps: int, skip_video: bool = False) -> torch.Tensor:
        y = super().forward(x)
        if skip_video:
            return y
        return _to_frames(self.time_mix_conv(_to_video(y, timesteps)))


class VideoAttnBlock(_Mixer, AttnBlock):
    """The VAE's single-head attention, whose output is α-merged with a
    one-head frame-axis transformer block over it plus a frame-position
    embedding, then projected and added to the input (time_mode "all")."""

    def __init__(self, channels: int, alpha: float = 0.0, merge_strategy: str = "learned"):
        super().__init__(channels)
        self.time_mix_block = VideoTransformerBlock(channels, heads=1, dim_head=channels,
                                                    ff_in=True)
        self.video_time_embed = nn.Sequential(nn.Linear(channels, 4 * channels), nn.SiLU(),
                                              nn.Linear(4 * channels, channels))
        self._init_mix(alpha, merge_strategy)

    def forward(self, x: torch.Tensor, timesteps: int, skip_video: bool = False) -> torch.Tensor:
        if skip_video:
            return super().forward(x)
        n, c, h, w = x.shape
        tokens = self.attend(x)  # (B·T, H·W, C)
        frame_idx = torch.arange(timesteps, dtype=torch.float32, device=x.device).repeat(
            n // timesteps)
        emb = self.video_time_embed(timestep_embedding(frame_idx, c).to(tokens.dtype))
        mix = self.time_mix_block(tokens + emb[:, None, :], timesteps=timesteps)
        alpha = self.alpha().to(tokens.dtype)
        tokens = alpha * tokens + (1.0 - alpha) * mix
        return x + self.proj_out(tokens.transpose(1, 2).reshape(n, c, h, w))


class VideoDecoder(Decoder):
    """`vae.Decoder` with per-`time_mode` temporal blocks; call it as
    `decoder(z, timesteps=T)` on (B·T, z, h, w) latents. With `skip_video`
    every block runs its spatial part alone (the 2-D decoder on the same
    spatial weights)."""

    def __init__(self, *args, video_kernel_size: Union[int, Sequence[int]] = 3,
                 alpha: float = 0.0, merge_strategy: str = "learned",
                 time_mode: str = "conv-only", **kwargs):
        if time_mode not in TIME_MODES:
            raise ValueError(f"time_mode {time_mode!r} not in {TIME_MODES}")
        # read by the block factories that Decoder.__init__ calls
        self.video_kernel_size = video_kernel_size
        self.alpha = alpha
        self.merge_strategy = merge_strategy
        self.time_mode = time_mode
        super().__init__(*args, **kwargs)

    def make_resblock(self, in_channels: int, out_channels: int) -> nn.Module:
        if self.time_mode == "attn-only":
            return ResnetBlock(in_channels, out_channels)
        return VideoResBlock(in_channels, out_channels, self.video_kernel_size, self.alpha,
                             self.merge_strategy)

    def make_attn(self, channels: int) -> nn.Module:
        if self.time_mode == "conv-only":
            return AttnBlock(channels)
        return VideoAttnBlock(channels, self.alpha, self.merge_strategy)

    def make_conv_out(self, in_channels: int, out_channels: int) -> nn.Module:
        if self.time_mode == "attn-only":
            return nn.Conv2d(in_channels, out_channels, 3, padding=1)
        return AE3DConv(in_channels, out_channels, self.video_kernel_size)

    def run_conv_out(self, h: torch.Tensor, **video) -> torch.Tensor:
        if isinstance(self.conv_out, AE3DConv):
            return self.conv_out(h, **video)
        return self.conv_out(h)

    def forward(self, z: torch.Tensor, timesteps: int, skip_video: bool = False) -> torch.Tensor:
        return super().forward(z, timesteps=timesteps, skip_video=skip_video)
