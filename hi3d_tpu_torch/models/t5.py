"""T5 encoder (the text encoder of FrozenT5Embedder, FrozenByT5Embedder and
FrozenCLIPT5Encoder). The JAX package borrows `transformers`'
`FlaxT5EncoderModel`; the card's machine has no `transformers`, so the port
writes the encoder out.

Each of `num_layers` blocks: T5's RMS norm in fp32 (no mean, no bias,
`layer_norm_epsilon`), self-attention with q/k/v/o without bias and without
1/√d scaling plus the bucketed bidirectional relative-position bias that the
first block owns and every block adds, then the RMS norm and the
feed-forward (`gated-gelu`: tanh-GELU(wi_0 x) · wi_1 x → wo; `relu`: wo
relu(wi x)), each residual. A final RMS norm closes the stack. No attention
mask: the JAX embedders call the model with `input_ids` alone, so padding is
attended.

Parameter names are the Hugging Face `T5EncoderModel`'s (`shared`,
`encoder.block.N.layer.0.SelfAttention.{q,k,v,o}`,
`encoder.block.0.layer.0.SelfAttention.relative_attention_bias`,
`encoder.block.N.layer.{0,1}.layer_norm`,
`encoder.block.N.layer.1.DenseReluDense.{wi_0,wi_1,wo}` or `{wi,wo}`,
`encoder.final_layer_norm`); `load_t5_directory` reads a local model
directory (`config.json` and `model.safetensors` or `pytorch_model.bin`).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# config.json keys the encoder reads, with Hugging Face's T5Config defaults
T5_DEFAULTS = {"vocab_size": 32128, "d_model": 512, "d_kv": 64, "d_ff": 2048, "num_layers": 6,
               "num_heads": 8, "relative_attention_num_buckets": 32,
               "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
               "feed_forward_proj": "relu"}


class T5LayerNorm(nn.Module):
    """RMS norm: x · rsqrt(mean(x²) + eps) in fp32, times the weight, in
    the weight's dtype."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * y.to(self.weight.dtype)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional bucket of each (key − query) offset: half the
    buckets for positive offsets; exact below num_buckets/4, logarithmic up
    to max_distance, the last bucket beyond."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float().clamp_min(1) / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp_max(num_buckets - 1)
    return buckets + torch.where(n < max_exact, n, large)


class T5Attention(nn.Module):
    def __init__(self, d_model: int, d_kv: int, heads: int, num_buckets: int = 0,
                 max_distance: int = 128):
        super().__init__()
        inner = d_kv * heads
        self.heads, self.d_kv = heads, d_kv
        self.q = nn.Linear(d_model, inner, bias=False)
        self.k = nn.Linear(d_model, inner, bias=False)
        self.v = nn.Linear(d_model, inner, bias=False)
        self.o = nn.Linear(inner, d_model, bias=False)
        self.num_buckets, self.max_distance = num_buckets, max_distance
        if num_buckets:
            self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def position_bias(self, s: int, device) -> torch.Tensor:
        """(1, H, S, S) fp32 bias of the first block."""
        pos = torch.arange(s, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                           self.max_distance)
        return self.relative_attention_bias(buckets).float().permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = (f(x).view(b, s, self.heads, self.d_kv) for f in (self.q, self.k, self.v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)
        return self.o(out.reshape(b, s, self.heads * self.d_kv))


class _DenseReluDense(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool):
        super().__init__()
        self.gated = gated
        if gated:
            self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
            self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        else:
            self.wi = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


def _gated(feed_forward_proj: str) -> bool:
    """Whether a config's `feed_forward_proj` is the gated tanh-GELU
    ("gated-gelu") rather than "relu"."""
    if feed_forward_proj in ("gated-gelu", "relu"):
        return feed_forward_proj == "gated-gelu"
    raise NotImplementedError(f"feed_forward_proj {feed_forward_proj!r} "
                              "(the port has gated-gelu and relu)")


class _Sublayer(nn.Module):
    """One `layer.N` entry: its `layer_norm` and its attention or feed-forward."""

    def __init__(self, name: str, module: nn.Module, d_model: int, eps: float):
        super().__init__()
        self.add_module(name, module)
        self.layer_norm = T5LayerNorm(d_model, eps)


class T5Block(nn.Module):
    def __init__(self, cfg: Dict, has_bias: bool):
        super().__init__()
        d, eps = cfg["d_model"], cfg["layer_norm_epsilon"]
        attn = T5Attention(d, cfg["d_kv"], cfg["num_heads"],
                           cfg["relative_attention_num_buckets"] if has_bias else 0,
                           cfg["relative_attention_max_distance"])
        ff = _DenseReluDense(d, cfg["d_ff"], _gated(cfg["feed_forward_proj"]))
        self.layer = nn.ModuleList([_Sublayer("SelfAttention", attn, d, eps),
                                    _Sublayer("DenseReluDense", ff, d, eps)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, i == 0) for i in range(cfg["num_layers"]))
        self.final_layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])


class T5EncoderModel(nn.Module):
    """T5 encoder over token ids (B, L) → last hidden state (B, L, d_model).
    Widths as keyword arguments under config.json's names (`T5_DEFAULTS`)."""

    def __init__(self, **config):
        super().__init__()
        cfg = {**T5_DEFAULTS, **{k: v for k, v in config.items() if k in T5_DEFAULTS}}
        self.config = cfg
        self.shared = nn.Embedding(cfg["vocab_size"], cfg["d_model"])
        self.encoder = T5Stack(cfg)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        x = self.shared(ids)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(ids.shape[1], ids.device)
        for block in blocks:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)


def t5_state_dict_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The encoder's entries of a Hugging Face T5 state dict: `shared.*` and
    `encoder.*` (a T5ForConditionalGeneration file's decoder and lm_head are
    dropped), `encoder.embed_tokens.weight` folded into `shared.weight`,
    whose tied copy it is."""
    out = {k: v for k, v in sd.items() if k.startswith(("shared.", "encoder."))}
    tied = out.pop("encoder.embed_tokens.weight", None)
    if "shared.weight" not in out and tied is not None:
        out["shared.weight"] = tied
    return out


def load_t5_directory(version: str, dtype: Optional[torch.dtype] = None) -> T5EncoderModel:
    """A T5 encoder from a local Hugging Face model directory: widths from
    `config.json`, weights from `model.safetensors` (read by
    `convert.read_safetensors`) or `pytorch_model.bin`, loaded with
    strict=True. A `version` that is no local directory raises, as
    `from_pretrained` does offline."""
    from ..convert import read_safetensors

    if not os.path.isdir(version):
        raise FileNotFoundError(
            f"T5 version {version!r} is not a local directory (config.json + model.safetensors "
            "or pytorch_model.bin); the port downloads nothing")
    with open(os.path.join(version, "config.json")) as f:
        config = json.load(f)
    st, bin_ = (os.path.join(version, n) for n in ("model.safetensors", "pytorch_model.bin"))
    if os.path.exists(st):
        sd = read_safetensors(st)
    elif os.path.exists(bin_):
        sd = torch.load(bin_, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{version}: neither model.safetensors nor pytorch_model.bin")
    model = T5EncoderModel(**config)
    model.load_state_dict(t5_state_dict_names(sd), strict=True)
    return model.to(dtype) if dtype is not None else model
