"""K1: spatial flash-attention forward, and #3: its backward.

K1 replaces hi3d_tpu/ops/flash_attention.py:_fwd (Pallas, reached through
`flash_attention` → `_flash3`); #3 replaces `_bwd` (the `_dkv_kernel` and
`_dq_kernel` Pallas calls of its custom VJP). Both CUDA kernels live in
`csrc/flash_attention.cu`, whose notes say what bounds them on the H100 and
how the designs answer.

`flash_attention(q, k, v)` takes (B, S, H, D) tensors with any batch,
sequence and head strides (unit D stride), so the (B, S, H·D) output of a
projection goes in as a view, and returns O (B, Sq, H, D) and the natural-log
lse (B, H, Sq) in fp32. When q, k or v needs a gradient it runs as an
autograd Function that saves q, k, v, O and lse, as the JAX custom VJP does,
and whose backward is #3. CPU tensors take the plain versions
(`flash_attention_reference`, `flash_attention_backward_reference`); CUDA
tensors take the kernels, which need bf16, D ∈ {64, 80, 128}, and 16-byte
aligned rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

SUPPORTED_HEAD_DIMS = (64, 80, 128)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: fp32 scores and softmax, O cast to v's dtype."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype), lse


def _check_cuda_inputs(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, D) with unit D stride")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} rows must be 16-byte aligned (strides {t.stride()})"
            )
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError("flash_attention: batch and heads must each be ≤ 65535")


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of #3's arithmetic in fp32: P = exp(Q Kᵀ·scale − lse)
    from the saved lse, Δ = rowsum(dO∘O), dV = Pᵀ dO, dS = P∘(dO Vᵀ − Δ),
    dQ = dS K·scale, dK = dSᵀ Q·scale; gradients in the inputs' dtypes."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    delta = torch.einsum("bqhd,bqhd->bhq", gf, out.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, scale):
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return flash_attention_reference(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    lib = build.load_library()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = build.stride_array(
        [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    )
    err = build.launch(
        lib.hi3d_flash_attention_fwd, q.get_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, sq, sk, h, d, strides, float(scale),
    )
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` for the cotangent `dout` of O, from
    the forward's saved O and lse. dq is (B, Sq, H, D), dk and dv
    (B, Sk, H, D), all contiguous."""
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return flash_attention_backward_reference(q, k, v, out, lse, dout, scale)
    _check_cuda_inputs(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if dout.dtype != torch.bfloat16 or out.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_backward: O {out.dtype} and dO {dout.dtype} must be bfloat16")
    if dout.shape != q.shape or out.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError("flash_attention_backward: O/dO/lse shapes do not match q")
    if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]) or dout.data_ptr() % 16:
        dout = dout.contiguous()
    out, lse = out.contiguous(), lse.contiguous()
    scale = d**-0.5 if scale is None else scale
    lib = build.load_library()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    strides = build.stride_array([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                  *out.stride()[:3], *dout.stride()[:3]])
    err = build.launch(
        lib.hi3d_flash_attention_bwd, q.get_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, d, strides, float(scale),
    )
    build.check(err, "flash_attention_backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, lse, dout, ctx.scale), None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Sq, H, D) × (B, Sk, H, D) → (O (B, Sq, H, D), lse (B, H, Sq) fp32)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


flash_attention.launches = 0
