"""Attention dispatch of the UNet (counterpart of hi3d_tpu/ops/attention.py).

One path per op:
- spatial self-attention → K1 (`flash_attention`), at every sequence length;
- frame-axis self-attention over (B, T, S, H, D) → K2 (`temporal_attention`)
  up to MAX_FRAMES = 32 frames, #6 (`segment_attention` on the transposed
  (B, S, T, H, D) views, no copy) above, and to plain torch
  (`temporal_attention_reference`) where neither kernel can take the call:
  head dims past 256, which the JAX package also leaves to plain einsums
  (`temporal_attention_supported`); `frame_attention_kernel` is the one
  predicate for that split (a CUDA call the kernels cannot take, such as
  fp32, raises in their wrappers);
- cross-attention against a single kv token → a value broadcast (softmax over
  one key is identically 1);
- cross-attention against several per-video tokens → plain torch (K1's
  plain version), as the JAX package leaves that einsum to XLA.

The JAX package splits frame-axis attention by a TPU VMEM budget instead
(`temporal_attention_fused`): its natural-layout kernel while a
(T, 8, C) tile fits 640 KB, else the location-major #6. At T = 48 in bf16
that is the natural kernel at the sites with C ≤ 640 and #6 at those with
C = 1280. The port's K2 stops at T = 32 (one key block), so the port
sends every site with T > 32 to #6. This is deliberate: both kernels compute
the same (query, key) pairs with the same fp32 softmax.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_reference
from .temporal_attention import (MAX_FRAMES, segment_attention, temporal_attention,
                                 temporal_attention_reference)

MAX_KERNEL_HEAD_DIM = 256  # past it the JAX package's frame axis is plain too


def self_attention(q, k, v) -> torch.Tensor:
    """(B, S, H, D) spatial self-attention."""
    return flash_attention(q, k, v)[0]


def cross_attention(q, k, v) -> torch.Tensor:
    """(B, Sq, H, D) queries against (B, Sk, H, D) context keys/values."""
    if k.shape[1] == 1:
        return v.expand(v.shape[0], q.shape[1], *v.shape[2:])
    return flash_attention_reference(q, k, v)[0]


def frame_attention_kernel(t: int, d: int) -> str:
    """The route of frame-axis self-attention over `t` frames of head dim
    `d`: "plain" (no kernel) when d > MAX_KERNEL_HEAD_DIM, where the JAX
    package's `temporal_attention_supported` is False too; else
    "temporal_attention" (K2) up to MAX_FRAMES frames and
    "temporal_block_attention" (#6) above. Each kernel's backward is the
    same name + "_backward"."""
    if d > MAX_KERNEL_HEAD_DIM:
        return "plain"
    return "temporal_attention" if t <= MAX_FRAMES else "temporal_block_attention"


def time_self_attention(q, k, v) -> torch.Tensor:
    """(B, T, S, H, D) self-attention along the frame axis."""
    route = frame_attention_kernel(q.shape[1], q.shape[-1])
    if route == "plain":
        return temporal_attention_reference(q, k, v)
    if route == "temporal_attention":
        return temporal_attention(q, k, v)
    return segment_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)


def time_cross_attention(q, k, v) -> torch.Tensor:
    """(B, T, S, H, D) queries against per-video (B, Sk, H, D) context."""
    if k.shape[1] == 1:
        return v[:, :, None].expand(q.shape)
    d = q.shape[-1]
    logits = torch.einsum("bqshd,bkhd->bshqk", q.float(), k.float()) * d**-0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bshqk,bkhd->bqshd", probs.float(), v.float()).to(v.dtype)
