"""DPT-hybrid (MiDaS) monocular depth, the stage-2 depth tower (counterpart of
hi3d_tpu/models/dpt.py).

NCHW, fp32. Parameter names are the MiDaS reference's (`dpt_hybrid_384.pt`):
`pretrained.model.{cls_token, pos_embed}`,
`pretrained.model.patch_embed.backbone.stem.{conv, norm}`,
`pretrained.model.patch_embed.backbone.stages.S.blocks.B.{downsample.conv,
downsample.norm, conv1..3, norm1..3}`, `pretrained.model.patch_embed.proj`,
`pretrained.model.blocks.I.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}`, `pretrained.act_postprocess3.{0.project.0, 3}`,
`pretrained.act_postprocess4.{0.project.0, 3, 4}`, `scratch.layerN_rn`,
`scratch.refinenetN.{resConfUnit1, resConfUnit2, out_conv}` and
`scratch.output_conv.{0, 2, 4}`, so hi3d_tpu/convert/torch_to_jax.py
`convert_dpt_key` maps this state dict onto the JAX tower one to one.

- backbone: ResNetV2 stem and stages (3, 4, 9) with weight-standardised
  convs (eps 1e-6) and TF-"SAME" padding on the strided convs, GroupNorm(32,
  eps 1e-5) on #9 (`FoldedGroupNorm`) with ReLU where timm's GroupNormAct
  applies it; taps at /4 (256 ch) and /8 (512 ch);
- ViT-B/16 on the /16 features (1×1 patch projection, class token,
  bilinear-resized position embedding), LayerNorms on #10 (eps 1e-6), taps
  after the blocks in `hooks`;
- 'project' readout (cat(tokens, cls) → Linear → GELU), reassembly convs,
  RefineNet fusion with ×2 align-corners upsampling, and the depth head.

Attention (577 tokens, 12 heads of 64 at 384²) is plain fp32 PyTorch (K1's
plain version), as the JAX package computes it in XLA below its flash
minimum. Input (B, 3, H, W) in [-1, 1], H and W multiples of 32; output
(B, H, W) non-negative inverse depth.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention_reference
from .attention import LayerNorm32
from .layers import FoldedGroupNorm


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) bilinear resize with align_corners=True, computed in fp32."""
    y = F.interpolate(x.float(), size=tuple(size), mode="bilinear", align_corners=True)
    return y.to(x.dtype)


def _same_pad(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """TF-"SAME" padding of H and W (lax.conv "SAME": the odd pixel goes last)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


class StdConv(nn.Conv2d):
    """Conv with weight standardisation per output channel (timm StdConv2d,
    eps 1e-6, biased variance); `same=True` pads TF-"SAME" (StdConv2dSame)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, same: bool = False):
        super().__init__(cin, cout, kernel, stride, padding=0 if same else kernel // 2, bias=False)
        self.same = same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) / torch.sqrt(var + 1e-6)).to(self.weight.dtype)
        if self.same:
            x = _same_pad(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, w, None, self.stride, self.padding)


class GroupNormAct(FoldedGroupNorm):
    """timm GroupNormAct: GroupNorm(32, eps 1e-5) on #9, then ReLU unless
    `apply_act` is False."""

    def __init__(self, channels: int, apply_act: bool = True):
        super().__init__(32, channels, eps=1e-5)
        self.apply_act = apply_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return F.relu(y) if self.apply_act else y


class _Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv = StdConv(cin, cout, 1, stride)
        self.norm = GroupNormAct(cout, apply_act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """timm ResNetV2 post-activation bottleneck: conv→GN-ReLU ×2, conv→GN,
    ReLU(out + shortcut); the shortcut is a 1×1 StdConv + GN when the shape
    changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        mid = cout // 4
        if cin != cout or stride != 1:
            self.downsample = _Downsample(cin, cout, stride)
        self.conv1 = StdConv(cin, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv(mid, mid, 3, stride, same=True)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv(mid, cout, 1)
        self.norm3 = GroupNormAct(cout, apply_act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


class HybridBackbone(nn.Module):
    """ResNetV2 stem + stages (3, 4, 9) of timm vit_base_r50_s16_384:
    returns (stage 0 at /4 · 256 ch, stage 1 at /8 · 512 ch, stage 2 at
    /16 · 1024 ch)."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = StdConv(3, 64, 7, 2, same=True)
        self.stem.norm = GroupNormAct(64)
        self.stages = nn.ModuleList()
        cin = 64
        for blocks, cout, stride in ((3, 256, 1), (4, 512, 2), (9, 1024, 2)):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                Bottleneck(cin if b == 0 else cout, cout, stride if b == 0 else 1)
                for b in range(blocks))
            self.stages.append(stage)
            cin = cout

    def forward(self, x: torch.Tensor):
        h = self.stem.norm(self.stem.conv(x))
        # 3×3 stride-2 max pool with (0, 1) padding on H and W (lax "SAME" at even sizes)
        h = F.max_pool2d(F.pad(h, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        feats = []
        for stage in self.stages:
            for block in stage.blocks:
                h = block(h)
            feats.append(h)
        return feats


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        q, k, v = (t.reshape(b, s, self.heads, c // self.heads)
                   for t in self.qkv(x).chunk(3, dim=-1))
        return self.proj(flash_attention_reference(q, k, v)[0].reshape(b, s, c))


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, width: int = 768, heads: int = 12):
        super().__init__()
        self.norm1 = LayerNorm32(width, eps=1e-6)
        self.attn = _Attention(width, heads)
        self.norm2 = LayerNorm32(width, eps=1e-6)
        self.mlp = _Mlp(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ProjectReadout(nn.Module):
    """'project' readout: cat(tokens, cls) → Linear(2w → w) → GELU."""

    def __init__(self, width: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * width, width), nn.GELU())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        grid = tokens[:, 1:]
        return self.project(torch.cat([grid, tokens[:, :1].expand_as(grid)], dim=-1))


class ResidualConvUnit(nn.Module):
    """ReLU → 3×3 conv → ReLU → 3×3 conv, + input (MiDaS, no batch norm)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Optional skip through resConfUnit1, resConfUnit2, ×2 align-corners
    upsample, 1×1 out conv. refinenet4 gets no skip; its resConfUnit1 exists
    in the reference checkpoint and is unused, as there."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_bilinear_align_corners(x, (2 * x.shape[2], 2 * x.shape[3]))
        return self.out_conv(x)


class DPTDepthModel(nn.Module):
    """(B, 3, H, W) in [-1, 1] → (B, H, W) non-negative inverse depth."""

    def __init__(self, features: int = 256, vit_width: int = 768, vit_layers: int = 12,
                 vit_heads: int = 12, hooks: Sequence[int] = (8, 11), pos_grid: int = 24):
        super().__init__()
        w = vit_width
        self.hooks = tuple(hooks)
        self.pos_grid = pos_grid
        vit = nn.Module()
        vit.cls_token = nn.Parameter(torch.zeros(1, 1, w))
        vit.pos_embed = nn.Parameter(torch.randn(1, 1 + pos_grid * pos_grid, w) * 0.02)
        vit.patch_embed = nn.Module()
        vit.patch_embed.backbone = HybridBackbone()
        vit.patch_embed.proj = nn.Conv2d(1024, w, 1)
        vit.blocks = nn.ModuleList(ViTBlock(w, vit_heads) for _ in range(vit_layers))
        self.pretrained = nn.Module()
        self.pretrained.model = vit
        self.pretrained.act_postprocess3 = nn.Sequential(
            ProjectReadout(w), nn.Identity(), nn.Identity(), nn.Conv2d(w, w, 1))
        self.pretrained.act_postprocess4 = nn.Sequential(
            ProjectReadout(w), nn.Identity(), nn.Identity(), nn.Conv2d(w, w, 1),
            nn.Conv2d(w, w, 3, stride=2, padding=1))
        f = features
        self.scratch = nn.Module()
        for i, cin in enumerate((256, 512, w, w), start=1):
            setattr(self.scratch, f"layer{i}_rn", nn.Conv2d(cin, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", FeatureFusionBlock(f))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(),  # ×2 upsample between
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """(1, 1 + gh·gw, w): the grid part bilinearly resized (antialiased,
        as jax.image.resize) from pos_grid², the class slot unchanged."""
        pos = self.pretrained.model.pos_embed
        g = self.pos_grid
        grid = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2).float()
        if (gh, gw) != (g, g):
            grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False,
                                 antialias=True)
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([pos[:, :1].float(), grid], dim=1).to(pos.dtype)

    def _reassemble(self, post: nn.Sequential, tokens: torch.Tensor, gh: int, gw: int):
        x = post[0](tokens)  # readout (B, gh·gw, w)
        x = x.transpose(1, 2).reshape(x.shape[0], -1, gh, gw)
        for conv in post[3:]:
            x = conv(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        gh, gw = hh // 16, ww // 16
        vit = self.pretrained.model
        layer1, layer2, feat = vit.patch_embed.backbone(x)
        tok = vit.patch_embed.proj(feat).flatten(2).transpose(1, 2)  # (B, gh·gw, w)
        t = torch.cat([vit.cls_token.expand(b, -1, -1), tok], dim=1) + self._pos_embed(gh, gw)
        taps = {}
        for i, block in enumerate(vit.blocks):
            t = block(t)
            if i in self.hooks:
                taps[i] = t
        layer3 = self._reassemble(self.pretrained.act_postprocess3, taps[self.hooks[0]], gh, gw)
        layer4 = self._reassemble(self.pretrained.act_postprocess4, taps[self.hooks[1]], gh, gw)
        s = self.scratch
        path = s.refinenet4(s.layer4_rn(layer4))
        path = s.refinenet3(path, s.layer3_rn(layer3))
        path = s.refinenet2(path, s.layer2_rn(layer2))
        path = s.refinenet1(path, s.layer1_rn(layer1))
        head = s.output_conv
        h = head[0](path)
        h = resize_bilinear_align_corners(h, (2 * h.shape[2], 2 * h.shape[3]))
        for layer in head[2:]:
            h = layer(h)
        return h[:, 0]
