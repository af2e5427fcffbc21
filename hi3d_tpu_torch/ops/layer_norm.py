"""#10: LayerNorm row statistics, with the normalise-and-affine in the same pass.

Replaces hi3d_tpu/ops/group_norm.py:_pallas_row_stats_impl (Pallas
`_rowstats_kernel`, reached through `pallas_row_stats` from the JAX
LayerNorm32 under HI3D_LN=pallas): per row of an (M, C) tensor, one-pass fp32
Σx and Σx², mean = Σx/C, var = max(Σx²/C − mean², 0), inv_std =
rsqrt(var + eps). The TPU kernel emitted only (mean, inv_std) and left the
apply to XLA, which fused it into the neighbouring ops; eager PyTorch fuses
nothing, so here the same pass also writes y = (x − mean)·inv_std·γ + β in
fp32, cast to x's dtype. That removes the fp32 copy of x and the cast back
that `F.layer_norm(x.float())` needed.

What bounds it on the H100: one read of x and one write of y, no matrix
product, so device-memory bandwidth. One program owns BLOCK_M whole rows
(C ≤ 8192, padded to a power of two): the row sums are register reductions
inside the program, so no partial sums cross programs and the result does
not depend on the launch order.

`triton` is imported on the first CUDA launch only (see `_compiled`).

Training: when x, γ or β needs a gradient `layer_norm` runs as an autograd
Function that saves x, mean, inv_std and γ; its backward is plain PyTorch
(`layer_norm_backward`), the same math as the JAX custom VJP, which
differentiates through `_row_stats_ref` and the jnp apply.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

tl = None  # bound to triton.language on the first CUDA launch
_KERNEL = None

MAX_C = 8192
_TILE = 4096  # elements a program holds: BLOCK_M · BLOCK_C


def _ln_kernel(x_ptr, y_ptr, w_ptr, b_ptr, mean_ptr, inv_ptr, m, c, stride_x, eps,
               APPLY: "tl.constexpr", BLOCK_M: "tl.constexpr", BLOCK_C: "tl.constexpr"):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.arange(0, BLOCK_C)
    rmask = rows < m
    cmask = cols < c
    mask = rmask[:, None] & cmask[None, :]
    r64 = rows.to(tl.int64)
    x = tl.load(x_ptr + r64[:, None] * stride_x + cols[None, :], mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / c
    var = tl.maximum(tl.sum(x * x, axis=1) / c - mean * mean, 0.0)
    inv = 1.0 / tl.sqrt(var + eps)
    tl.store(mean_ptr + rows, mean, mask=rmask)
    tl.store(inv_ptr + rows, inv, mask=rmask)
    if APPLY:
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        y = (x - mean[:, None]) * inv[:, None] * w[None, :] + b[None, :]
        tl.store(y_ptr + r64[:, None] * c + cols[None, :], y.to(y_ptr.dtype.element_ty), mask=mask)


def _compiled():
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _KERNEL = triton.jit(_ln_kernel)
    return _KERNEL


def row_stats_reference(x2d: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: fp32 (M,) mean and inv_std, one-pass, variance clamped
    at 0 (`_rowstats_kernel` / `_row_stats_ref`)."""
    xf = x2d.float()
    mean = xf.mean(-1)
    var = torch.clamp((xf * xf).mean(-1) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def _apply_reference(x, weight, bias, mean, inv):
    c = x.shape[-1]
    y = (x.float().reshape(-1, c) - mean[:, None]) * inv[:, None]
    return (y * weight.float() + bias.float()).reshape(x.shape).to(x.dtype)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """Plain version of the fused pass: `row_stats_reference`, then the fp32
    apply, cast to x's dtype."""
    mean, inv = row_stats_reference(x.reshape(-1, x.shape[-1]), eps)
    return _apply_reference(x, weight, bias, mean, inv)


def layer_norm_backward(x, weight, mean, inv, dy):
    """(dx, dγ, dβ) for the cotangent dy, from the saved fp32 mean and
    inv_std: with x̂ = (x − mean)·inv and g = dy·γ,
    dx = inv·(g − mean(g) − x̂·mean(g·x̂)); results in the inputs' dtypes."""
    c = x.shape[-1]
    xhat = (x.float().reshape(-1, c) - mean[:, None]) * inv[:, None]
    dyf = dy.float().reshape(-1, c)
    g = dyf * weight.float()
    dx = inv[:, None] * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype), (dyf * xhat).sum(0).to(weight.dtype),
            dyf.sum(0).to(weight.dtype))


def _launch(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
            eps: float):
    """One #10 launch on a CUDA tensor: (y or None, mean, inv_std)."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"layer_norm: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    if not 1 <= c <= MAX_C:
        raise ValueError(f"layer_norm: C={c} outside 1..{MAX_C}")
    x2d = x.reshape(-1, c)
    if x2d.stride(-1) != 1:
        x2d = x2d.contiguous()
    m = x2d.shape[0]
    block_c = max(16, 1 << (c - 1).bit_length())
    block_m = max(1, _TILE // block_c)
    mean = torch.empty((m,), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    apply = weight is not None
    if apply:
        y = torch.empty((m, c), dtype=x.dtype, device=x.device)
        w = weight.detach().to(device=x.device, dtype=torch.float32).contiguous()
        b = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    else:
        y = w = b = mean  # unread placeholders
    kernel = _compiled()
    with torch.cuda.device(x.device):
        kernel[(-(-m // block_m),)](
            x2d, y, w, b, mean, inv, m, c, x2d.stride(0), float(eps),
            APPLY=apply, BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4 if block_c <= 1024 else 8,
        )
    return (y.reshape(x.shape) if apply else None), mean, inv


def row_stats(x2d: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 per-row (mean, inv_std) of (M, C): the #10 kernel (stats only)
    on CUDA tensors, `row_stats_reference` on CPU tensors."""
    if x2d.device.type == "cpu":
        return row_stats_reference(x2d, eps)
    _, mean, inv = _launch(x2d, None, None, eps)
    row_stats.launches += 1
    return mean, inv


def _forward(x, weight, bias, eps):
    """(y, mean, inv_std) of LayerNorm over the last dim."""
    if x.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            mean, inv = row_stats_reference(x.reshape(-1, x.shape[-1]), eps)
            return _apply_reference(x, weight, bias, mean, inv), mean, inv
    y, mean, inv = _launch(x, weight, bias, eps)
    layer_norm.launches += 1
    return y, mean, inv


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, inv = _forward(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, inv = ctx.saved_tensors
        return (*layer_norm_backward(x, weight, mean, inv, dy), None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics and apply, output in
    x's dtype: the #10 kernel on CUDA tensors, the plain version on CPU."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps)[0]


layer_norm.launches = 0
row_stats.launches = 0
