"""InceptionV3 FID feature extractor (counterpart of hi3d_tpu/models/inception.py;
sgm's `InceptionV3` embedder, a wrapper of pytorch-fid's network).

`InceptionV3Trunk` is torchvision's Inception-v3 trunk under torchvision's
names (`Conv2d_1a_3x3.conv`, `Mixed_5b.branch5x5_1.bn`, ...): BasicConv2d =
conv without bias, BatchNorm with eps 1e-3 on its running statistics, ReLU;
the four FID blocks (0: to the first max pool, 64 ch; 1: to the second, 192
ch; 2: Mixed_5b–6e, 768 ch; 3: Mixed_7a–7c and the global mean, 2048 ch).
With `fid_variant` (pytorch-fid's patched blocks) the pool branches of the
A, C and E_1 (Mixed_7b) blocks average without counting padding and E_2
(Mixed_7c) max-pools; without it they are torchvision's include-pad
averages. `InceptionV3` resizes to 299² (jax.image.resize's antialiased
bilinear), maps [0, 1] → [-1, 1] with `normalize_input`, and squeezes the
pooled map to (B, 2048). Weights: a torchvision / pytorch-fid state dict
(`ckpt_path`) loaded with strict=True after its `fc` and `AuxLogits` heads
are dropped. Inputs are NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .clip import image_resize


class _BatchNorm(nn.Module):
    """BatchNorm2d on its running statistics (inference only)."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor, exclude_pad: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not exclude_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, exclude_pad: bool):
        super().__init__()
        self.exclude_pad = exclude_pad
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, self.exclude_pad))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, exclude_pad: bool):
        super().__init__()
        self.exclude_pad = exclude_pad
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool(x, self.exclude_pad))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """`pool_mode`: "avg_exclude_pad", "avg_include_pad" or "max"."""

    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = _avg_pool(x, self.pool_mode == "avg_exclude_pad")
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Trunk(nn.Module):
    """The trunk; forward returns the maps of `output_blocks` (a list)."""

    def __init__(self, output_blocks: Sequence[int] = (3,), fid_variant: bool = True):
        super().__init__()
        self.output_blocks = tuple(output_blocks)
        xp = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, xp)
        self.Mixed_5c = InceptionA(256, 64, xp)
        self.Mixed_5d = InceptionA(288, 64, xp)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, xp)
        self.Mixed_6c = InceptionC(768, 160, xp)
        self.Mixed_6d = InceptionC(768, 160, xp)
        self.Mixed_6e = InceptionC(768, 192, xp)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_exclude_pad" if xp else "avg_include_pad")
        self.Mixed_7c = InceptionE(2048, "max" if xp else "avg_include_pad")

    def forward(self, x: torch.Tensor):
        blocks = (
            ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "max"),
            ("Conv2d_3b_1x1", "Conv2d_4a_3x3", "max"),
            ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
             "Mixed_6e"),
            ("Mixed_7a", "Mixed_7b", "Mixed_7c", "mean"),
        )
        outs = {}
        for i, names in enumerate(blocks[:max(self.output_blocks) + 1]):
            for name in names:
                if name == "max":
                    x = F.max_pool2d(x, 3, 2)
                elif name == "mean":
                    x = x.mean(dim=(2, 3), keepdim=True)
                else:
                    x = getattr(self, name)(x)
            outs[i] = x
        return [outs[i] for i in self.output_blocks]


class InceptionV3(nn.Module):
    """The config-facing embedder: 299² resize, optional [0, 1] → [-1, 1],
    the trunk, and (B, 2048) features for a single pooled block."""

    def __init__(self, normalize_input: bool = False, resize_input: bool = True,
                 output_blocks: Sequence[int] = (3,), ckpt_path: Optional[str] = None,
                 fid_variant: bool = True, **_unused):
        super().__init__()
        self.normalize_input = normalize_input
        self.resize_input = True if resize_input is None else bool(resize_input)
        self.model = InceptionV3Trunk(output_blocks, fid_variant)
        if ckpt_path is not None:
            from ..convert import load_inception_state_dict

            self.model.load_state_dict(load_inception_state_dict(ckpt_path), strict=True)

    def forward(self, x: torch.Tensor):
        if self.resize_input and tuple(x.shape[-2:]) != (299, 299):
            x = image_resize(x, (299, 299), "bilinear")
        if self.normalize_input:
            x = 2.0 * x - 1.0
        outs = self.model(x)
        if len(outs) == 1:
            out = outs[0]
            return out.flatten(1) if out.shape[-2:] == (1, 1) else out
        return outs
