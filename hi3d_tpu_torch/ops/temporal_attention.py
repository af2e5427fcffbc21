"""K2: frame-axis (temporal) self-attention forward, and #5: its backward.

K2 replaces hi3d_tpu/ops/temporal_attention.py:_nat_fwd (Pallas, reached
through `temporal_attention_natural` ← `temporal_attention_fused`); #5
replaces `_nat_bwd` (the Pallas call of its custom VJP). Both CUDA kernels
live in `csrc/temporal_attention.cu`, whose notes say what bounds them on the
H100 and how the designs answer.

`temporal_attention(q, k, v)` takes (B, T, S, H, D) tensors whose last two
dims are the packed (H·D) channels of a projection output (head stride D,
unit D stride; any batch, frame and location strides) and returns
(B, T, S, H, D): for each (b, s, h), softmax over the T frames. When q, k or
v needs a gradient it runs as an autograd Function that saves q, k, v and O,
as the JAX custom VJP does, and whose backward is #5. CPU tensors take the
plain versions (`temporal_attention_reference`,
`temporal_attention_backward_reference`); CUDA tensors take the kernels,
which need bf16, T ≤ 32 and D ∈ {64, 128}.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

MAX_FRAMES = 32
SUPPORTED_HEAD_DIMS = (64, 128)


def temporal_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Plain version: fp32 scores and softmax over the frame axis."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("bqshd,bkshd->bshqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshqk,bkshd->bqshd", probs, v.float())
    return out.to(v.dtype)


def _check_cuda_inputs(q, k, v) -> None:
    if q.shape != k.shape or q.shape != v.shape or q.ndim != 5:
        raise ValueError(f"temporal_attention: q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    _, t, _, _, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"temporal_attention: {name} must be on {q.device}, got {x.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"temporal_attention: {name} must be bfloat16, got {x.dtype}")
        if x.stride(-1) != 1 or x.stride(-2) != d:
            raise ValueError(f"temporal_attention: {name} must pack heads as (…, H·D) channels")
        if any(s % 2 for s in x.stride()[:3]) or x.data_ptr() % 4:
            raise ValueError(f"temporal_attention: {name} strides {x.stride()} not 4-byte aligned")
    if not 1 <= t <= MAX_FRAMES:
        raise ValueError(f"temporal_attention: T={t} outside 1..{MAX_FRAMES}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"temporal_attention: head dim {d} not in {SUPPORTED_HEAD_DIMS}")


def temporal_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of #5's arithmetic in fp32: P recomputed by softmax,
    Δ = rowsum(dO∘O), dV = Pᵀ dO, dS = P∘(dO Vᵀ − Δ), dQ = dS K·scale,
    dK = dSᵀ Q·scale; gradients in the inputs' dtypes."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    p = torch.softmax(torch.einsum("bqshd,bkshd->bshqk", qf, kf) * scale, dim=-1)
    delta = torch.einsum("bqshd,bqshd->bshq", gf, out.float())
    dv = torch.einsum("bshqk,bqshd->bkshd", p, gf)
    ds = p * (torch.einsum("bqshd,bkshd->bshqk", gf, vf) - delta[..., None])
    dq = torch.einsum("bshqk,bkshd->bqshd", ds, kf) * scale
    dk = torch.einsum("bshqk,bqshd->bkshd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, scale):
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return temporal_attention_reference(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    b, t, s, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    lib = build.load_library()
    out = torch.empty((b, t, s, h, d), dtype=q.dtype, device=q.device)
    strides = build.stride_array([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hi3d_temporal_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, s, h, d, strides, float(scale), stream,
        )
    build.check(err, "temporal_attention")
    temporal_attention.launches += 1
    return out


def _packed(x: torch.Tensor) -> bool:
    d = x.shape[-1]
    return (x.stride(-1) == 1 and x.stride(-2) == d and not any(s % 2 for s in x.stride()[:3])
            and x.data_ptr() % 4 == 0)


def temporal_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `temporal_attention` for the cotangent `dout` of O,
    from the forward's saved O; each contiguous (B, T, S, H, D)."""
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return temporal_attention_backward_reference(q, k, v, out, dout, scale)
    _check_cuda_inputs(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("temporal_attention_backward: O/dO shapes do not match q")
    if out.dtype != torch.bfloat16 or dout.dtype != torch.bfloat16:
        raise TypeError(f"temporal_attention_backward: O {out.dtype} and dO {dout.dtype} must be bfloat16")
    out = out if _packed(out) else out.contiguous()
    dout = dout if _packed(dout) else dout.contiguous()
    b, t, s, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    lib = build.load_library()
    dq, dk, dv = (torch.empty((b, t, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    strides = build.stride_array([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                  *out.stride()[:3], *dout.stride()[:3]])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hi3d_temporal_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, s, h, d, strides,
            float(scale), stream,
        )
    build.check(err, "temporal_attention_backward")
    temporal_attention_backward.launches += 1
    return dq, dk, dv


temporal_attention_backward.launches = 0


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*temporal_attention_backward(q, k, v, out, dout, ctx.scale), None)


def temporal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """(B, T, S, H, D) frame-axis self-attention → (B, T, S, H, D)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _TemporalAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


temporal_attention.launches = 0
