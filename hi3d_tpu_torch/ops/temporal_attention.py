"""Frame-axis (temporal) self-attention: K2 and its backward #5 for clips of
up to 32 frames, #6 and its backward #7 for longer ones.

K2 replaces hi3d_tpu/ops/temporal_attention.py:_nat_fwd (Pallas, reached
through `temporal_attention_natural` ← `temporal_attention_fused`); #5
replaces `_nat_bwd` (the Pallas call of its custom VJP). Both CUDA kernels
live in `csrc/temporal_attention.cu`, whose notes say what bounds them on the
H100 and how the designs answer: K2 is #6's forward specialised to one key
block (groups of adjacent segments, a two-stage cp.async ring, mma.sync on
tensor cores, a persistent grid), and #5 is K2's backward built the same way
(query-major warps form S and dP and sum dQ, then sum dK and dV of their key
tile from the bf16 P and dS in shared memory).

`temporal_attention(q, k, v)` takes (B, T, S, H, D) tensors whose last two
dims are the packed (H·D) channels of a projection output (head stride D,
unit D stride; any batch, frame and location strides) and returns
(B, T, S, H, D): for each (b, s, h), softmax over the T frames; K2 copies
16 bytes at a time, so the (b, t, s) strides must be multiples of 8 elements
on a 16-byte aligned base, which the UNet's projections are. When q, k or
v needs a gradient it runs as an autograd Function that saves q, k, v and O,
as the JAX custom VJP does, and whose backward is #5. #5 copies 16 bytes at
a time too; `temporal_attention_backward` copies an operand off that rule
(`_aligned`) instead of rejecting it. CPU tensors take the
plain versions (`temporal_attention_reference`,
`temporal_attention_backward_reference`); CUDA tensors take the kernels,
which need bf16, T ≤ 32 and D ∈ {64, 128}.

#6 replaces `_fwd3` (segment-local attention on location-major tokens, O and
an fp32 lse) and #7 replaces `_bwd3` (its backward from lse and Δ); both are
CUDA C++ in `csrc/block_attention.cu`: #6 a persistent kernel over groups of
segments with keys in blocks of 64 frames and an online softmax, #7 a
persistent kernel over groups of segments and frame blocks of 64 (128 at
D = 64 from 256 frames; past 64 frames after a Δ pre-pass), whose key-major
warps sum dK and dV and whose query-major warps sum dQ.
`segment_attention(q, k, v)` takes strided (B, S, T, H, D) views, the
segment along axis 2, so the UNet's (B, T, S, H, D) projections go in as
`.transpose(1, 2)` views with no copy; `temporal_block_attention(q, k, v,
seg_len)` is the JAX package's (B, S·T, H, D) signature on top of it. With a
gradient it runs as an autograd Function that saves q, k, v, O and lse, as
`_block_local_fwd` does, and whose backward is #7
(`temporal_block_attention_backward`). CUDA tensors need bf16, T ≥ 2 and
D ∈ {64, 128}.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

MAX_FRAMES = 32  # K2's limit (one key block of at most 32 frames)
K2_ALIGN = 8  # K2's (b, t, s) strides and base: whole 16-byte vectors
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
    """Raise unless q, k, v are CUDA bf16 (B, T, S, H, D) tensors of one
    shape with packed heads, (b, t, s) strides and bases aligned to
    K2_ALIGN elements, T ≤ MAX_FRAMES and D in SUPPORTED_HEAD_DIMS."""
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
        if not _packed(x):
            raise ValueError(f"temporal_attention: {name} strides {x.stride()} or base not "
                             f"aligned to {2 * K2_ALIGN} bytes")
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
    err = build.launch(
        lib.hi3d_temporal_attention_fwd, q.get_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, s, h, d, strides, float(scale),
    )
    build.check(err, "temporal_attention")
    temporal_attention.launches += 1
    return out


def _packed(x: torch.Tensor, elems: int = K2_ALIGN) -> bool:
    """Packed heads (head stride D, unit dim stride), and the three leading
    strides and the base aligned to `elems` bf16 elements: every kernel here
    moves 16-byte vectors (8)."""
    d = x.shape[-1]
    return (x.stride(-1) == 1 and x.stride(-2) == d
            and not any(s % elems for s in x.stride()[:3]) and x.data_ptr() % (2 * elems) == 0)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when #5 can copy it in 16-byte vectors (`_packed`), else a
    contiguous copy in fresh (aligned) memory."""
    return x if _packed(x) else x.clone(memory_format=torch.contiguous_format)


def temporal_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `temporal_attention` for the cotangent `dout` of O,
    from the forward's saved O; each contiguous (B, T, S, H, D). An operand
    whose strides or base are off #5's 16-byte rule is copied first; the
    copies stay bound until the launch returns."""
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return temporal_attention_backward_reference(q, k, v, out, dout, scale)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("temporal_attention_backward: O/dO shapes do not match q")
    if out.dtype != torch.bfloat16 or dout.dtype != torch.bfloat16:
        raise TypeError(f"temporal_attention_backward: O {out.dtype} and dO {dout.dtype} must be bfloat16")
    q, k, v, out, dout = (_aligned(x) for x in (q, k, v, out, dout))
    _check_cuda_inputs(q, k, v)
    if out.device != q.device or dout.device != q.device:
        raise ValueError(f"temporal_attention_backward: O and dO must be on {q.device}")
    b, t, s, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    lib = build.load_library()
    dq, dk, dv = (torch.empty((b, t, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    strides = build.stride_array([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                  *out.stride()[:3], *dout.stride()[:3]])
    err = build.launch(
        lib.hi3d_temporal_attention_bwd, q.get_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, s, h, d, strides,
        float(scale),
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


# ---------------------------------------------------------------- #6 and #7


def temporal_block_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of #6 on (B, S, T, H, D) segments: fp32 scores and
    softmax over each segment's T frames. Returns O (B, S, T, H, D) in v's
    dtype and the natural-log lse (B, H, S, T) in fp32."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("bsqhd,bskhd->bhsqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhsqk,bskhd->bsqhd", probs, v.float())
    return out.to(v.dtype), lse


def temporal_block_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of #7's arithmetic in fp32: P = exp(Q Kᵀ·scale − lse),
    Δ = rowsum(dO∘O), dV = Pᵀ dO, dS = P∘(dO Vᵀ − Δ), dQ = dS K·scale,
    dK = dSᵀ Q·scale; gradients in the inputs' dtypes."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    p = torch.exp(torch.einsum("bsqhd,bskhd->bhsqk", qf, kf) * scale - lse.float()[..., None])
    delta = torch.einsum("bsqhd,bsqhd->bhsq", gf, out.float())
    dv = torch.einsum("bhsqk,bsqhd->bskhd", p, gf)
    ds = p * (torch.einsum("bsqhd,bskhd->bhsqk", gf, vf) - delta[..., None])
    dq = torch.einsum("bhsqk,bskhd->bsqhd", ds, kf) * scale
    dk = torch.einsum("bhsqk,bsqhd->bskhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_segments(name: str, *xs: torch.Tensor) -> None:
    q = xs[0]
    if q.ndim != 5 or any(x.shape != q.shape for x in xs):
        raise ValueError(f"{name}: (B, S, T, H, D) inputs of one shape, got "
                         f"{[tuple(x.shape) for x in xs]}")
    _, _, t, _, d = q.shape
    for x in xs:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name}: inputs must be on {q.device}, got {x.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: inputs must be bfloat16, got {x.dtype}")
        if not _packed(x, 8):
            raise ValueError(f"{name}: strides {x.stride()} need packed heads and (b, s, t) "
                             "strides that are multiples of 8 on a 16-byte aligned base")
    if t < 2:
        raise ValueError(f"{name}: segment length T={t} below 2")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {SUPPORTED_HEAD_DIMS}")


def _empty_like(x: torch.Tensor) -> torch.Tensor:
    """An output in x's memory order (so a transposed view stays one), or
    contiguous when that order would not be aligned."""
    y = torch.empty_like(x)
    return y if _packed(y, 8) else torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _block_forward(q, k, v, scale):
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return temporal_block_attention_reference(q, k, v, scale)
    _check_segments("temporal_block_attention", q, k, v)
    b, s, t, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    lib = build.load_library()
    out = _empty_like(q)
    lse = torch.empty((b, h, s, t), dtype=torch.float32, device=q.device)
    strides = build.stride_array([st for x in (q, k, v, out) for st in x.stride()[:3]])
    err = build.launch(
        lib.hi3d_block_attention_fwd, q.get_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, s, t, h, d, strides, float(scale),
    )
    build.check(err, "temporal_block_attention")
    temporal_block_attention.launches += 1
    return out, lse


def temporal_block_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """#7: (dq, dk, dv) of `segment_attention` for the cotangent `dout` of O,
    from the forward's saved O and lse (B, H, S, T); each gradient in its
    input's memory order."""
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return temporal_block_attention_backward_reference(q, k, v, out, lse, dout, scale)
    out = out if _packed(out, 8) else out.contiguous()
    dout = dout if _packed(dout, 8) else dout.contiguous()
    _check_segments("temporal_block_attention_backward", q, k, v, out, dout)
    b, s, t, h, d = q.shape
    if lse.shape != (b, h, s, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"temporal_block_attention_backward: lse must be contiguous fp32 "
                         f"{(b, h, s, t)}, got {lse.dtype} {tuple(lse.shape)}")
    scale = d**-0.5 if scale is None else scale
    lib = build.load_library()
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(v)
    delta = torch.empty_like(lse)  # Δ scratch of the pre-pass that runs past 64 frames
    strides = build.stride_array([st for x in (q, k, v, out, dout, dq, dk, dv)
                                  for st in x.stride()[:3]])
    err = build.launch(
        lib.hi3d_block_attention_bwd, q.get_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, t, h, d, strides, float(scale),
    )
    build.check(err, "temporal_block_attention_backward")
    temporal_block_attention_backward.launches += 1
    return dq, dk, dv


temporal_block_attention_backward.launches = 0


class _TemporalBlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _block_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*temporal_block_attention_backward(q, k, v, out, lse, dout, ctx.scale), None)


def segment_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """(B, S, T, H, D) segments, any (b, s, t) strides → O (B, S, T, H, D):
    for each (b, s, h), softmax over the segment's T frames (#6)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _TemporalBlockAttention.apply(q, k, v, scale)
    return _block_forward(q, k, v, scale)[0]


def temporal_block_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_len: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, S·T, H, D) segment-local attention, tokens location-major and
    frame-minor: query i attends key j iff i // seg_len == j // seg_len (the
    signature of hi3d_tpu.ops.temporal_attention.temporal_block_attention)."""
    b, st, h, d = q.shape
    if st % seg_len:
        raise ValueError(f"temporal_block_attention: {st} tokens are not whole segments of "
                         f"{seg_len}")

    def seg(x):
        return x.unflatten(1, (st // seg_len, seg_len))

    return segment_attention(seg(q), seg(k), seg(v), scale).flatten(1, 2)


temporal_block_attention.launches = 0
