"""CLIP towers (counterpart of hi3d_tpu/models/clip.py): the OpenCLIP
ViT-H/14 image tower (crossattn conditioning), OpenAI CLIP ViT-L/14 + the
LAION aesthetic MLP (aesthetic score), and the CLIP/OpenCLIP text tower
(`CLIPTextTransformer`: `text_vit_h_14`, `text_vit_l_14`).

Parameter names are the open_clip / OpenAI-CLIP `visual.*` layout
(`conv1`, `class_embedding`, `positional_embedding`, `ln_pre`,
`transformer.resblocks.N.{ln_1,attn.in_proj_weight,attn.out_proj,ln_2,
mlp.c_fc,mlp.c_proj}`, `ln_post`, `proj`), and `layers.{0,2,4,6,7}` for the
MLP. Inputs are NCHW, already CLIP-normalised. The tower attention (257
tokens) is plain matmul + softmax (K1's plain version), as in the JAX package.
The text tower's names are open_clip's top-level text names
(`token_embedding`, `positional_embedding`, `transformer.resblocks.N.*`,
`ln_final`, `text_projection`), which the OpenAI jit archive shares; its
causal attention over 77 tokens is plain too (JAX leaves it to XLA).
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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = −0.5 (jax.image.resize "cubic")."""
    x = np.abs(x)
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, (1.5 * x - 2.5) * x * x + 1.0)
    return np.where(x >= 2.0, 0.0, out)


_RESIZE_KERNELS = {"bilinear": lambda x: np.maximum(0.0, 1.0 - np.abs(x)), "cubic": _keys_cubic}


@functools.lru_cache(maxsize=32)
def resize_weights(n_in: int, n_out: int, method: str, antialias: bool = True) -> np.ndarray:
    """(n_out, n_in) float32 resampling matrix of jax.image.resize along one
    axis: half-pixel sample positions, the kernel widened by in/out when
    downscaling with `antialias`, each row normalised to sum 1; computed in
    float32 as JAX computes it."""
    f32 = np.float32
    inv_scale = n_in / n_out
    kernel_scale = f32(max(inv_scale, 1.0) if antialias else 1.0)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _RESIZE_KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0)).T.astype(f32))


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output pixel of jax.image.resize "nearest":
    floor((i + 0.5)·in/out) in float32 (torch's "nearest-exact")."""
    f32 = np.float32
    return np.floor((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)).astype(
        np.int64)


def image_resize(x: torch.Tensor, hw, method: str, antialias: bool = True) -> torch.Tensor:
    """jax.image.resize of the last two axes of x to `hw`: "nearest"
    (half-pixel centres), "bilinear" or "cubic" (Keys a = −0.5), both
    antialiased when downscaling unless `antialias` is False. An axis whose
    size does not change is left alone, as in JAX. Linear and cubic
    resample in fp32 and return x's dtype."""
    h, w = x.shape[-2:]
    if method == "nearest":
        if hw[0] != h:
            x = x.index_select(-2, torch.from_numpy(_nearest_index(h, hw[0])).to(x.device))
        if hw[1] != w:
            x = x.index_select(-1, torch.from_numpy(_nearest_index(w, hw[1])).to(x.device))
        return x
    y = x.float()
    if hw[0] != h:
        ah = torch.from_numpy(resize_weights(h, hw[0], method, antialias)).to(x.device)
        y = torch.einsum("oh,...hw->...ow", ah, y)
    if hw[1] != w:
        aw = torch.from_numpy(resize_weights(w, hw[1], method, antialias)).to(x.device)
        y = torch.einsum("pw,...hw->...hp", aw, y)
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """Half-pixel bilinear resize without antialiasing (jax.image.resize "bilinear")."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain causal self-attention on (B, S, H, D): fp32 scores, query i sees
    keys 0..i, probabilities cast to v's dtype, O in v's dtype."""
    s, d = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float()).to(v.dtype)


class _MHA(nn.Module):
    """Self-attention with a packed qkv projection (nn.MultiheadAttention
    names); `causal` masks each query to the keys at or before it (the text
    tower)."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        d = c // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, s, self.heads, d) for t in (q, k, v))
        out = causal_attention(q, k, v) if self.causal else flash_attention_reference(q, k, v)[0]
        return self.out_proj(out.reshape(b, s, c))


class _ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, quick_gelu: bool, causal: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm32(width)
        self.attn = _MHA(width, heads, causal)
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
    def __init__(self, width: int, layers: int, heads: int, quick_gelu: bool,
                 causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            _ResidualAttentionBlock(width, heads, quick_gelu, causal) for _ in range(layers)
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


class CLIPTextTransformer(nn.Module):
    """CLIP/OpenCLIP text tower: a causal pre-LN transformer over token ids
    (B, L) (BPE tokenisation is the caller's). Returns (pooled (B, proj_dim),
    tokens (B, L, width), {"hidden": embeddings and each block's output,
    "final": ln_final of the last}) as the JAX tower does with
    `output_hidden`; `pooled` is the EOT position (argmax of the ids) of
    "final" through `text_projection`."""

    def __init__(self, vocab_size: int = 49408, width: int = 1024, layers: int = 24,
                 heads: int = 16, context_length: int = 77, proj_dim: int = 1024,
                 quick_gelu: bool = False):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = _Transformer(width, layers, heads, quick_gelu, causal=True)
        self.ln_final = LayerNorm32(width)
        self.text_projection = nn.Parameter(torch.randn(width, proj_dim) * width**-0.5)
        nn.init.normal_(self.token_embedding.weight, std=0.02)

    def forward(self, ids: torch.Tensor):
        ids = ids.long()
        dtype = self.token_embedding.weight.dtype
        x = self.token_embedding(ids) + self.positional_embedding[:ids.shape[1]].to(dtype)
        hidden = [x]
        for block in self.transformer.resblocks:
            x = block(x)
            hidden.append(x)
        final = self.ln_final(x)
        eot = ids.argmax(dim=-1)
        pooled = final[torch.arange(ids.shape[0], device=ids.device), eot] @ \
            self.text_projection.to(final.dtype)
        return pooled, x, {"hidden": tuple(hidden), "final": final}


def text_vit_h_14() -> CLIPTextTransformer:
    """OpenCLIP ViT-H/14 text tower (width 1024, 24 layers, 16 heads)."""
    return CLIPTextTransformer()


def text_vit_l_14() -> CLIPTextTransformer:
    """OpenAI CLIP ViT-L/14 text tower (width 768, 12 layers, 12 heads, QuickGELU)."""
    return CLIPTextTransformer(width=768, layers=12, heads=12, proj_dim=768, quick_gelu=True)
