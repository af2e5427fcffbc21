"""U²-Net salient-object segmentation (counterpart of hi3d_tpu/models/u2net.py):
the background-removal model of the stage-1 CLI's preprocessing, the model
that `rembg` runs.

Module names are upstream's (xuebinqin/U-2-Net `u2net.py`:
`stage1.rebnconvin.conv_s1`, `stage1.rebnconvin.bn_s1`, `stage5d`, `side1`,
`outconv`, …), so a released `u2net.pth` / `u2netp.pth` loads with a strict
`load_state_dict` (`convert.load_u2net`). NCHW, fp32 throughout, as the JAX
model's default dtype.

- REBNConv: 3×3 conv (dilation d, padding d) → frozen BatchNorm → ReLU. The
  BatchNorm applies its running statistics as an fp32 affine, in training
  mode too.
- RSU-L: conv_in, then an (L−1)-level mini U-Net at `mid_ch` with ceil-mode
  2×2 max pools, a dilation-2 bottom conv and concat-skip decoders; residual
  add with conv_in's output. RSU-4F is the pool-free variant (dilations
  1, 2, 4, 8 down, 4, 2, 1 up).
- U²-Net: 6 encoder stages, 5 decoder stages, 6 side heads upsampled to the
  input size and a 1×1 fusion conv; every output through a sigmoid.

Inside the model every resize is an upsampling (ceil-mode pools keep each
skip at least as large as twice the deeper map), where antialiasing changes
nothing. `preprocess` and `postprocess` scale down as well (to 320², and the
mask back to a smaller source), and there JAX's `jax.image.resize(...,
"bilinear")` antialiases by default: `resize_bilinear_aa` does the same.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def resize_bilinear_aa(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """(N, C, H, W) half-pixel bilinear resize, antialiased when scaling down
    (jax.image.resize "bilinear" with its default antialias=True)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


def _upsample_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=ref.shape[2:], mode="bilinear", align_corners=False)


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with its running statistics applied as an fp32 affine,
    whatever the module's mode; upstream's state-dict keys."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        add = self.bias.float() - self.running_mean.float() * mul
        return (x.float() * mul[:, None, None] + add[:, None, None]).to(x.dtype)


class REBNConv(nn.Module):
    """3×3 conv (dilated, same size) → frozen BN → ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn_s1(self.conv_s1(x)))


class RSU(nn.Module):
    """ReSidual U-block of height L (RSU-7 … RSU-4): convs 1..L−1 at `mid_ch`
    with ceil-mode max pools after convs 1..L−2, the dilation-2 conv L at the
    bottom, decoders (L−1)d..1d on concat(deeper feature, skip)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNConv(in_ch, out_ch)
        self.pool = nn.MaxPool2d(2, 2, ceil_mode=True)
        for i in range(1, height):
            setattr(self, f"rebnconv{i}", REBNConv(out_ch if i == 1 else mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", REBNConv(mid_ch, mid_ch, dirate=2))
        for i in range(height - 1, 0, -1):
            setattr(self, f"rebnconv{i}d", REBNConv(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = self.height
        hxin = self.rebnconvin(x)
        feats: List[torch.Tensor] = []
        hx = hxin
        for i in range(1, L):
            hx = getattr(self, f"rebnconv{i}")(hx)
            feats.append(hx)
            if i <= L - 2:
                hx = self.pool(hx)
        hx = getattr(self, f"rebnconv{L}")(feats[-1])
        for i in range(L - 1, 0, -1):
            skip = feats[i - 1]
            if hx.shape[2:] != skip.shape[2:]:
                hx = _upsample_like(hx, skip)
            hx = getattr(self, f"rebnconv{i}d")(torch.cat([hx, skip], dim=1))
        return hx + hxin


class RSU4F(nn.Module):
    """Pool-free RSU: dilations 1, 2, 4, 8 down, 4, 2, 1 up."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNConv(in_ch, out_ch)
        self.rebnconv1 = REBNConv(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNConv(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNConv(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNConv(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNConv(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNConv(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNConv(2 * mid_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        hx1 = self.rebnconv1(hxin)
        hx2 = self.rebnconv2(hx1)
        hx3 = self.rebnconv3(hx2)
        hx4 = self.rebnconv4(hx3)
        hx3d = self.rebnconv3d(torch.cat([hx4, hx3], dim=1))
        hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], dim=1))
        hx1d = self.rebnconv1d(torch.cat([hx2d, hx1], dim=1))
        return hx1d + hxin


# (height or "4F", in, mid, out) of stages 1..6, then 5d..1d
_FULL = ((7, 3, 32, 64), (6, 64, 32, 128), (5, 128, 64, 256), (4, 256, 128, 512),
         ("4F", 512, 256, 512), ("4F", 512, 256, 512),
         ("4F", 1024, 256, 512), (4, 1024, 128, 256), (5, 512, 64, 128), (6, 256, 32, 64),
         (7, 128, 16, 64))
_LITE = ((7, 3, 16, 64), (6, 64, 16, 64), (5, 64, 16, 64), (4, 64, 16, 64),
         ("4F", 64, 16, 64), ("4F", 64, 16, 64),
         ("4F", 128, 16, 64), (4, 128, 16, 64), (5, 128, 16, 64), (6, 128, 16, 64),
         (7, 128, 16, 64))
_STAGES = ("stage1", "stage2", "stage3", "stage4", "stage5", "stage6",
           "stage5d", "stage4d", "stage3d", "stage2d", "stage1d")


class U2Net(nn.Module):
    """U²-Net saliency model: `full=True` is u2net, `full=False` u2netp.

    (B, 3, H, W) preprocessed input → (d0, [d1..d6]), each (B, out_ch, H, W)
    fp32 sigmoid maps. Any H, W ≥ 32 (ceil-mode pools, size-matched
    upsampling)."""

    def __init__(self, full: bool = True, in_ch: int = 3, out_ch: int = 1):
        super().__init__()
        for name, (h, cin, mid, cout) in zip(_STAGES, _FULL if full else _LITE):
            cin = in_ch if name == "stage1" else cin
            setattr(self, name, RSU4F(cin, mid, cout) if h == "4F" else RSU(h, cin, mid, cout))
        self.pool = nn.MaxPool2d(2, 2, ceil_mode=True)
        side_in = (64, 64, 128, 256, 512, 512) if full else (64,) * 6
        for i, c in enumerate(side_in):
            setattr(self, f"side{i + 1}", nn.Conv2d(c, out_ch, 3, padding=1))
        self.outconv = nn.Conv2d(6 * out_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        skips = []
        hx = x
        for i in range(1, 6):
            hx = getattr(self, f"stage{i}")(hx)
            skips.append(hx)
            hx = self.pool(hx)
        hx = self.stage6(hx)
        outs = [hx]
        for i in range(5, 0, -1):
            skip = skips[i - 1]
            hx = getattr(self, f"stage{i}d")(torch.cat([_upsample_like(hx, skip), skip], dim=1))
            outs.append(hx)
        sides = []
        for i, feat in enumerate(reversed(outs)):  # hx1d .. hx6
            d = getattr(self, f"side{i + 1}")(feat)
            if d.shape[2:] != x.shape[2:]:
                d = _upsample_like(d, x)
            sides.append(d)
        d0 = self.outconv(torch.cat(sides, dim=1))
        return torch.sigmoid(d0.float()), [torch.sigmoid(d.float()) for d in sides]


# --------------------------------------------------------------------------
# rembg's u2net session: pre- and post-processing
# --------------------------------------------------------------------------


def preprocess(rgb, size: int = 320, device=None) -> torch.Tensor:
    """uint8 or float (H, W, 3) → (1, 3, size, size) on `device`: bilinear
    resize to size², divided by the image's max, ImageNet mean and
    (.229, .224, .225) std."""
    x = torch.as_tensor(np.asarray(rgb), device=device).to(torch.float32)
    x = resize_bilinear_aa(x.permute(2, 0, 1)[None], (size, size))
    x = x / x.max().clamp_min(1e-6)
    mean = torch.tensor(MEAN, device=x.device)[:, None, None]
    std = torch.tensor(STD, device=x.device)[:, None, None]
    return (x - mean) / std


def postprocess(d0: torch.Tensor, out_size: Sequence[int]) -> torch.Tensor:
    """Fused side output (1, 1, h, w) → (H, W) float mask in [0, 1] at the
    source size: min-max normalised, then resized."""
    lo, hi = d0.min(), d0.max()
    m = (d0 - lo) / (hi - lo).clamp_min(1e-6)
    return resize_bilinear_aa(m, out_size)[0, 0]


@torch.no_grad()
def segment(model: U2Net, rgb, size: int = 320) -> torch.Tensor:
    """rembg's mask for one (H, W, 3) image, on the model's device."""
    device = next(model.parameters()).device
    d0, _ = model(preprocess(rgb, size=size, device=device))
    return postprocess(d0, np.asarray(rgb).shape[:2])
