"""KL autoencoder, the SD f=8 VAE (counterpart of hi3d_tpu/models/vae.py).

NCHW, fp32 by default. Parameter names follow the reference
(`encoder.down.0.block.1.norm1`, `encoder.mid.attn_1.q`,
`decoder.up.3.upsample.conv`, `quant_conv`, `post_quant_conv`). GroupNorms
are eps 1e-6 fp32 `FoldedGroupNorm`s, whose statistics are #9. The
mid-block attention is single-head matmul + softmax in plain torch
(K1's plain version). `AutoencoderKL.decode_tiled` decodes a latent wider
than one tile in feathered, overlapping blocks (the engine's
`decode_tile_size`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention_reference
from .layers import FoldedGroupNorm


def _norm(c: int) -> FoldedGroupNorm:
    return FoldedGroupNorm(math.gcd(c, 32), c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, **_video) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over H·W tokens."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """(n, h·w, c): the attention output over the normed x's tokens,
        before proj_out."""
        n, c, h, w = x.shape
        hn = self.norm(x)
        # (n, h·w, 1, c): h·w tokens, one head
        q, k, v = (m(hn).reshape(n, c, h * w, 1).permute(0, 2, 3, 1)
                   for m in (self.q, self.k, self.v))
        return flash_attention_reference(q, k, v)[0][:, :, 0]

    def forward(self, x: torch.Tensor, **_video) -> torch.Tensor:
        n, c, h, w = x.shape
        return x + self.proj_out(self.attend(x).transpose(1, 2).reshape(n, c, h, w))


class Downsample(nn.Module):
    """Stride-2 conv after a (0, 1, 0, 1) zero pad."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _level(blocks, attns, resample_name=None, resample=None) -> nn.Module:
    level = nn.Module()
    level.block = nn.ModuleList(blocks)
    level.attn = nn.ModuleList(attns)
    if resample is not None:
        setattr(level, resample_name, resample)
    return level


def _mid(ch: int, resblock=ResnetBlock, attn=AttnBlock) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = resblock(ch, ch)
    mid.attn_1 = attn(ch)
    mid.block_2 = resblock(ch, ch)
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor, **video) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h, **video), **video), **video)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, double_z: bool = True,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 in_channels: int = 3, **_decoder_keys):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        block_in = ch
        curr_res = resolution
        for i, mult in enumerate(ch_mult):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in))
            last = i == len(ch_mult) - 1
            self.down.append(_level(blocks, attns, "downsample",
                                    None if last else Downsample(block_in)))
            if not last:
                curr_res //= 2
        self.mid = _mid(block_in)
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """The 2-D decoder. Its blocks are made by `make_resblock`, `make_attn`
    and `make_conv_out`, which `temporal_ae.VideoDecoder` overrides; the
    keyword arguments of `forward` go to every block and to conv_out (the
    video decoder's `timesteps`, `skip_video`; none here)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, out_ch: int = 3,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 **_encoder_keys):
        super().__init__()
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (len(ch_mult) - 1)
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _mid(block_in, self.make_resblock, self.make_attn)
        levels = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(self.make_resblock(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
                if curr_res in attn_resolutions:
                    attns.append(self.make_attn(block_in))
            levels[i] = _level(blocks, attns, "upsample", Upsample(block_in) if i else None)
            if i:
                curr_res *= 2
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(block_in)
        self.conv_out = self.make_conv_out(block_in, out_ch)

    def make_resblock(self, in_channels: int, out_channels: int) -> nn.Module:
        return ResnetBlock(in_channels, out_channels)

    def make_attn(self, channels: int) -> nn.Module:
        return AttnBlock(channels)

    def make_conv_out(self, in_channels: int, out_channels: int) -> nn.Module:
        return nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def run_conv_out(self, h: torch.Tensor, **_video) -> torch.Tensor:
        return self.conv_out(h)

    def forward(self, z: torch.Tensor, **video) -> torch.Tensor:
        h = _run_mid(self.mid, self.conv_in(z), **video)
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = block(h, **video)
                if len(level.attn):
                    h = level.attn[j](h, **video)
            if i:
                h = level.upsample(h)
        return self.run_conv_out(F.silu(self.norm_out(h)), **video)


def _tile_starts(n: int, tile: int, overlap: int):
    """Block offsets along an axis of `n` latent pixels: every `tile −
    overlap`, and one more pinned to the far edge when the stride leaves a
    remainder."""
    starts = list(range(0, max(n - tile, 0) + 1, tile - overlap))
    if starts[-1] + tile < n:
        starts.append(n - tile)
    return starts


def _ramp(size: int, fade: int, lo: bool, hi: bool, device) -> torch.Tensor:
    """(size,) feather weights: 1, faded in over the first `fade` pixels
    when `lo` and out over the last `fade` when `hi` (interior seams only)."""
    wgt = torch.ones((size,), dtype=torch.float32, device=device)
    if lo:
        wgt[:fade] = torch.linspace(0.0, 1.0, fade + 2, device=device)[1:-1]
    if hi:
        wgt[-fade:] = torch.linspace(1.0, 0.0, fade + 2, device=device)[1:-1]
    return wgt


class DiagonalGaussianDistribution:
    """Posterior N(mean, diag(exp(logvar))) from (N, 2·z, h, w) moments."""

    def __init__(self, parameters: torch.Tensor):
        self.mean, logvar = parameters.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """(N,) KL divergence to N(0, I): ½·Σ(μ² + σ² − 1 − log σ²) over all
        but the batch dim, with the clamped log-variance."""
        return 0.5 * (self.mean.pow(2) + torch.exp(self.logvar) - 1.0 - self.logvar).sum(
            dim=tuple(range(1, self.mean.ndim)))


class AutoencoderKL(nn.Module):
    """Encoder + quant convs + Decoder; `encode` draws from the posterior when
    given a generator, else returns its mode."""

    sample_posterior = True

    def __init__(self, ddconfig: dict, embed_dim: int = 4, lossconfig: Optional[dict] = None,
                 **_unused):
        super().__init__()
        dd = dict(ddconfig)
        dd.pop("attn_type", None)
        dd.pop("dropout", None)
        self.encoder = Encoder(**dd)
        self.decoder = Decoder(**dd)
        double = 2 if dd.get("double_z", True) else 1
        z = dd.get("z_channels", 4)
        self.quant_conv = nn.Conv2d(double * z, double * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z, 1)
        self.upsample_factor = 2 ** (len(dd.get("ch_mult", (1, 2, 4, 4))) - 1)
        self.out_ch = dd.get("out_ch", 3)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        posterior = DiagonalGaussianDistribution(self.quant_conv(self.encoder(x)))
        if self.sample_posterior and generator is not None:
            return posterior.sample(generator)
        return posterior.mode()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def decode_tiled(self, z: torch.Tensor, tile: int = 64, overlap: int = 16) -> torch.Tensor:
        """Decode (N, C, h, w) latents in `tile`² latent blocks that overlap by
        `overlap` latent pixels, cross-faded linearly across interior seams
        (the last block of a row or column is pinned to the edge); the
        weighted sum is kept in fp32 and divided by the summed weights. Peak
        memory is one block's decoder activations."""
        n, _, h, w = z.shape
        if h <= tile and w <= tile:
            return self.decode(z)
        if tile <= overlap:
            raise ValueError(f"decode tile {tile} must exceed its overlap {overlap}")
        f, fade = self.upsample_factor, overlap * self.upsample_factor
        ys, xs = _tile_starts(h, tile, overlap), _tile_starts(w, tile, overlap)
        out = torch.zeros((n, self.out_ch, h * f, w * f), dtype=torch.float32, device=z.device)
        acc = torch.zeros((h * f, w * f), dtype=torch.float32, device=z.device)
        for yi, y0 in enumerate(ys):
            for xi, x0 in enumerate(xs):
                patch = self.decode(z[:, :, y0:y0 + tile, x0:x0 + tile]).float()
                ph, pw = patch.shape[2:]
                wy = _ramp(ph, fade, yi > 0, yi < len(ys) - 1, z.device)
                wx = _ramp(pw, fade, xi > 0, xi < len(xs) - 1, z.device)
                wgt = wy[:, None] * wx[None, :]
                out[:, :, y0 * f:y0 * f + ph, x0 * f:x0 * f + pw] += patch * wgt
                acc[y0 * f:y0 * f + ph, x0 * f:x0 * f + pw] += wgt
        return (out / acc.clamp_min(1e-8)).to(z.dtype)


class AutoencoderKLModeOnly(AutoencoderKL):
    """Deterministic posterior mode (encodes the conditioning frame)."""

    sample_posterior = False
