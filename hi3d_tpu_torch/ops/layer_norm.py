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

The kernel is CUDA C++ (`csrc/norm_stats.cu`, built by `build.py`), whose
notes say what bounds it on the H100 (one read of x, one write of y: memory
bandwidth, and the launch at small shapes) and how the design answers: up
to C = 2048 a row takes an aligned group of 4–32 lanes of a warp with the
row in registers, past that (or with too few rows to fill the card) a block
a row, up to 8192; fixed-order shuffle sums (bitwise repeatable), γ and β
read in their own dtype, any row stride. Each call is one kernel launched through
one ctypes call on PyTorch's current stream: no cast, copy or fill beside
it.

Training: when x, γ or β needs a gradient `layer_norm` runs as an autograd
Function that saves x, mean, inv_std and γ; its backward is plain PyTorch
(`layer_norm_backward`), the same math as the JAX custom VJP, which
differentiates through `_row_stats_ref` and the jnp apply.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

MAX_C = 8192


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
            eps: float, stats: bool = True):
    """One #10 launch on a CUDA tensor: (y, or None without γ and β;
    mean, inv_std, or None and None unless `stats`). The host path is kept to
    a few tensor calls: it runs ~3000 times a stage-1 run."""
    if not x.is_cuda:
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    code = build.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"layer_norm: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    if not 1 <= c <= MAX_C:
        raise ValueError(f"layer_norm: C={c} outside 1..{MAX_C}")
    if x.is_contiguous():
        x2d, m, row_stride = x, x.numel() // c, c
    else:
        x2d = x.reshape(-1, c)
        if x2d.stride(-1) != 1:
            x2d = x2d.contiguous()
        m, row_stride = x2d.shape[0], x2d.stride(0)
    dev = x.get_device()
    nbytes = x.element_size()
    x_ptr = x2d.data_ptr()
    vec = x_ptr % 16 == 0 and row_stride * nbytes % 16 == 0 and c * nbytes % 16 == 0
    y = mean = inv = None
    y_ptr = w_ptr = b_ptr = mean_ptr = inv_ptr = None
    w_code = 0
    if weight is not None:
        w_code = build.DTYPE_CODES.get(weight.dtype)
        if w_code is None or weight.shape != (c,) or bias.shape != (c,):
            raise TypeError(f"layer_norm: γ {weight.dtype}{tuple(weight.shape)}, β "
                            f"{bias.dtype}{tuple(bias.shape)} for C={c}")
        if weight.get_device() != dev or bias.get_device() != dev:
            raise ValueError(f"layer_norm: γ on {weight.device}, β on {bias.device}, x on "
                             f"{x.device}")
        # the contiguous γ/β stay bound to these names until the launch has
        # returned: a temporary's pointer would name freed memory
        weight = weight.contiguous()
        bias = bias.to(weight.dtype).contiguous()
        w_ptr, b_ptr = weight.data_ptr(), bias.data_ptr()
        vec = vec and w_ptr % 16 == 0 and b_ptr % 16 == 0
        y = torch.empty(x.shape, dtype=x.dtype, device=dev)
        y_ptr = y.data_ptr()
    if stats:
        mean, inv = torch.empty((2, m), dtype=torch.float32, device=dev).unbind(0)
        mean_ptr, inv_ptr = mean.data_ptr(), inv.data_ptr()
    err = build.launch(build.load_library().hi3d_layer_norm, dev, x_ptr, y_ptr, w_ptr, b_ptr,
                       mean_ptr, inv_ptr, m, c, row_stride, code, w_code, vec, eps)
    build.check(err, "layer_norm")
    return y, mean, inv


def row_stats(x2d: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 per-row (mean, inv_std) of (M, C): the #10 kernel (stats only)
    on CUDA tensors, `row_stats_reference` on CPU tensors."""
    if x2d.device.type == "cpu":
        return row_stats_reference(x2d, eps)
    _, mean, inv = _launch(x2d, None, None, eps)
    row_stats.launches += 1
    return mean, inv


def _forward(x, weight, bias, eps, stats):
    """(y, mean, inv_std) of LayerNorm over the last dim; on the card the
    statistics are written only when `stats` (else None)."""
    if x.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            mean, inv = row_stats_reference(x.reshape(-1, x.shape[-1]), eps)
            return _apply_reference(x, weight, bias, mean, inv), mean, inv
    out = _launch(x, weight, bias, eps, stats)
    layer_norm.launches += 1
    return out


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, inv = _forward(x, weight, bias, eps, True)
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
    return _forward(x, weight, bias, eps, False)[0]


layer_norm.launches = 0
row_stats.launches = 0
