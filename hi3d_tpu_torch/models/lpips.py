"""LPIPS perceptual distance (counterpart of hi3d_tpu/models/lpips.py).

VGG16's `features` up to relu5_3 with taps after relu1_2, relu2_2, relu3_3,
relu4_3 and relu5_3; on [-1, 1] NCHW images shifted and scaled to
ImageNet's statistics; each tap divided by its per-location channel norm
(at least 1e-10, as the JAX package computes it), the squared difference
weighted by a bias-free 1×1 head, averaged over space and summed over the
taps. Returns (B,). The weights are frozen.

Names are the reference's (`net.slice1.0`, `net.slice2.5`, …, torchvision's
`features` indices inside five slices; `lin0.model.1`, …). The JAX package
names the second conv of its first two slices `conv3` and `conv8` where
torchvision has 2 and 7, so its `convert_lpips_key` maps `features.2` and
`features.7` to convs that its module lacks; the port keeps torchvision's
indices. `load_lpips_params` reads the reference's `vgg.pth` heads and a
torchvision VGG16 state dict.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn as nn

# torchvision VGG16 `features`: the slices' index ranges and their convs
_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))
_CONVS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256), 12: (256, 256),
          14: (256, 256), 17: (256, 512), 19: (512, 512), 21: (512, 512), 24: (512, 512),
          26: (512, 512), 28: (512, 512)}
_POOLS = (4, 9, 16, 23)
TAP_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _layer(i: int) -> nn.Module:
    if i in _CONVS:
        cin, cout = _CONVS[i]
        return nn.Conv2d(cin, cout, 3, padding=1)
    return nn.MaxPool2d(2, 2) if i in _POOLS else nn.ReLU()


class VGG16Features(nn.Module):
    """VGG16 up to relu5_3 as five slices; returns the five tap activations."""

    def __init__(self):
        super().__init__()
        for k, (lo, hi) in enumerate(_SLICES, start=1):
            setattr(self, f"slice{k}",
                    nn.Sequential(OrderedDict((str(i), _layer(i)) for i in range(lo, hi))))

    def forward(self, x: torch.Tensor):
        taps = []
        for k in range(1, len(_SLICES) + 1):
            x = getattr(self, f"slice{k}")(x)
            taps.append(x)
        return taps


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """The bias-free 1×1 head of a tap (slot 0 is the reference's dropout,
    which is off: LPIPS always runs in eval mode)."""

    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(chn_in, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-10)


class LPIPS(nn.Module):
    """Perceptual distance between two [-1, 1] NCHW images with 3 channels."""

    def __init__(self, use_dropout: bool = True):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = VGG16Features()
        for i, c in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{i}", NetLinLayer(c))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != 3 or y.shape[1] != 3:
            raise ValueError(f"LPIPS compares 3-channel images (its ImageNet shift and scale are "
                             f"per RGB channel), got {x.shape[1]} and {y.shape[1]} channels")
        fx, fy = self.net(self.scaling_layer(x)), self.net(self.scaling_layer(y))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = getattr(self, f"lin{i}")((_unit(a) - _unit(b)) ** 2)
            total = total + d.mean(dim=(1, 2, 3))
        return total


def _slice_of(idx: int) -> int:
    return next(k for k, (lo, hi) in enumerate(_SLICES, start=1) if lo <= idx < hi)


def convert_lpips_key(key: str) -> Optional[str]:
    """The port's name for a key of the reference's `vgg.pth` (`linN.model.1.
    weight`), of a torchvision VGG16 (`features.N.*`; the classifier is
    dropped) or of the reference's whole LPIPS (`net.sliceK.N.*`); None for
    keys the port has no parameter for."""
    parts = key.split(".")
    if parts[0].startswith("lin") and parts[0][3:].isdigit():
        return key
    if parts[0] == "features" or (parts[0] == "net" and len(parts) > 3 and parts[2] == "features"):
        idx, leaf = (parts[1], parts[2:]) if parts[0] == "features" else (parts[3], parts[4:])
        if int(idx) not in _CONVS:
            return None
        return ".".join(["net", f"slice{_slice_of(int(idx))}", idx, *leaf])
    if parts[0] == "net" and parts[1].startswith("slice"):
        return key
    return None


def load_lpips_params(lpips_path: Optional[str] = None,
                      vgg_path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The LPIPS state dict from the reference's checkpoints: the heads from
    `lpips_path` (`vgg.pth`), the convs from `vgg_path` (torchvision)."""
    from ..convert import load_checkpoint_file

    sd: Dict[str, torch.Tensor] = {}
    for path in (vgg_path, lpips_path):
        if path:
            for k, v in load_checkpoint_file(path).items():
                name = convert_lpips_key(k)
                if name is not None:
                    sd[name] = v
    return sd
