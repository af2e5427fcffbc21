"""CLIP image towers (counterpart of hi3d_tpu/models/clip.py): OpenCLIP
ViT-H/14 (crossattn conditioning) and OpenAI CLIP ViT-L/14 + the LAION
aesthetic MLP (aesthetic score).

Parameter names are the open_clip / OpenAI-CLIP `visual.*` layout
(`conv1`, `class_embedding`, `positional_embedding`, `ln_pre`,
`transformer.resblocks.N.{ln_1,attn.in_proj_weight,attn.out_proj,ln_2,
mlp.c_fc,mlp.c_proj}`, `ln_post`, `proj`), and `layers.{0,2,4,6,7}` for the
MLP. Inputs are NCHW, already CLIP-normalised. The tower attention (257
tokens) is plain matmul + softmax (K1's plain version), as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention_reference
from .attention import LayerNorm32

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(x01: torch.Tensor) -> torch.Tensor:
    """Normalise [0, 1] RGB (N, 3, H, W) with the CLIP mean/std."""
    mean = torch.tensor(CLIP_MEAN, dtype=x01.dtype, device=x01.device)[:, None, None]
    std = torch.tensor(CLIP_STD, dtype=x01.dtype, device=x01.device)[:, None, None]
    return (x01 - mean) / std


def aa_bicubic_weights(n_in: int, n_out: int, align_corners: bool = True) -> np.ndarray:
    """(n_out, n_in) antialiased bicubic resampling matrix with the semantics
    of torch's interpolate(mode="bicubic", antialias=True) — the same matrix
    as hi3d_tpu/models/clip.py:_aa_bicubic_weights."""
    if align_corners and n_out > 1:
        scale = (n_in - 1) / (n_out - 1)
    else:
        scale = n_in / n_out
    invs = 1.0 / scale if scale > 1 else 1.0
    support = 2.0 * scale if scale > 1 else 2.0

    def cubic(x, a=-0.5):
        x = np.abs(x)
        return np.where(
            x < 1,
            ((a + 2) * x - (a + 3)) * x * x + 1,
            np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0),
        )

    weights = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = scale * (i + 0.5)
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        w = cubic((np.arange(xmin, xmax) - center + 0.5) * invs)
        weights[i, xmin:xmax] = w / w.sum()
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _aa_weights_cached(n_in: int, n_out: int) -> np.ndarray:
    return aa_bicubic_weights(n_in, n_out)


def resize_bicubic(x: torch.Tensor, hw) -> torch.Tensor:
    """Antialiased bicubic resize of (N, C, H, W) as two fp32 matmuls."""
    ah = torch.from_numpy(_aa_weights_cached(x.shape[2], hw[0])).to(x.device)
    aw = torch.from_numpy(_aa_weights_cached(x.shape[3], hw[1])).to(x.device)
    y = torch.einsum("oh,nchw->ncow", ah, x.float())
    return torch.einsum("pw,ncow->ncop", aw, y).to(x.dtype)


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """Half-pixel bilinear resize without antialiasing (jax.image.resize "bilinear")."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


class _MHA(nn.Module):
    """Self-attention with a packed qkv projection (nn.MultiheadAttention names)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        d = c // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, s, self.heads, d) for t in (q, k, v))
        out = flash_attention_reference(q, k, v)[0]
        return self.out_proj(out.reshape(b, s, c))


class _ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, quick_gelu: bool):
        super().__init__()
        self.ln_1 = LayerNorm32(width)
        self.attn = _MHA(width, heads)
        self.ln_2 = LayerNorm32(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width))
        self.mlp.add_module("gelu", nn.Identity())
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width))
        self.quick_gelu = quick_gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        h = self.mlp.c_fc(self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return x + self.mlp.c_proj(h)


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, quick_gelu: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            _ResidualAttentionBlock(width, heads, quick_gelu) for _ in range(layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class CLIPVisionTransformer(nn.Module):
    """Pre-LN CLIP image encoder → projected pooled embedding (N, output_dim)."""

    def __init__(self, width: int = 1280, layers: int = 32, heads: int = 16,
                 patch_size: int = 14, image_size: int = 224, output_dim: int = 1024,
                 quick_gelu: bool = False):
        super().__init__()
        self.image_size, self.output_dim = image_size, output_dim
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(width) * width**-0.5)
        self.positional_embedding = nn.Parameter(torch.randn(grid * grid + 1, width) * width**-0.5)
        self.ln_pre = LayerNorm32(width)
        self.transformer = _Transformer(width, layers, heads, quick_gelu)
        self.ln_post = LayerNorm32(width)
        self.proj = nn.Parameter(torch.randn(width, output_dim) * width**-0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.conv1.weight.dtype))
        b, width = x.shape[:2]
        x = x.reshape(b, width, -1).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj.to(x.dtype)


def vit_h_14() -> CLIPVisionTransformer:
    """OpenCLIP ViT-H-14 visual tower."""
    return CLIPVisionTransformer(width=1280, layers=32, heads=16, patch_size=14, output_dim=1024)


def vit_l_14() -> CLIPVisionTransformer:
    """OpenAI CLIP ViT-L/14 visual tower (QuickGELU)."""
    return CLIPVisionTransformer(width=1024, layers=24, heads=16, patch_size=14, output_dim=768,
                                 quick_gelu=True)


class AestheticMLP(nn.Module):
    """LAION aesthetic predictor head: 768 → 1024 → 128 → 64 → 16 → 1 (the
    dropouts are inactive at inference)."""

    def __init__(self, input_size: int = 768):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Linear(input_size, 1024), nn.Dropout(0.2), nn.Linear(1024, 128),
            nn.Dropout(0.2), nn.Linear(128, 64), nn.Dropout(0.1), nn.Linear(64, 16),
            nn.Linear(16, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)
