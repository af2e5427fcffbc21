"""K3: GroupNorm(+SiLU) forward, and #9: GroupNorm statistics alone.

Replaces hi3d_tpu/ops/group_norm.py:_fused_group_norm_nsc (Pallas
`_stats_kernel` + `_apply_kernel`, reached through `fused_group_norm` /
`GroupNorm32`): per-group Σx and Σx² in fp32, mean and variance (clamped at
0, as `_group_stats` does), the folded affine a = γ·σ⁻¹, b = β − μ·a, and
y = act(x·a + b) in fp32 with the optional SiLU applied before the cast.

The kernel is Triton and works on PyTorch's contiguous (N, C, *spatial)
layout, where one group is one contiguous run of (C/G)·prod(spatial)
elements; it serves both the 2-D ResBlock tensors (N = B·T frames) and the
5-D time-stack tensors (N = B, spatial = T·H·W).

What bounds it on the H100: two reads and one write of x, no matrix product,
so device-memory bandwidth. The TPU kernel carried its sums across a
sequential grid axis; blocks on Hopper run in no order, so the stats pass
splits each group over several programs that write partial sums, and the
apply pass folds those partials itself (no third launch, no atomics, so the
result is deterministic). The split keeps ~1k programs in flight when N·G is
small (the 5-D time-stack tensors have only B·32 groups).

#9 replaces hi3d_tpu/ops/group_norm.py:_pallas_group_stats_impl (Pallas
`_gstats_kernel`, reached through `pallas_group_stats` under HI3D_GN=pallas):
fp32 per-group (mean, inv_std) of shape (N, G), one-pass and clamped as
above. It is CUDA C++ (`csrc/norm_stats.cu`, built by `build.py`), one
launch a call: a thread-block cluster of 1–8 CTAs a group streams the
group's slices, and its rank 0 folds the partial sums from the other CTAs'
shared memory (no scratch tensor, no atomics, deterministic). The cluster
size comes from `plan_group_stats`. Its callers (the VAE's and the DPT's
fp32 GroupNorms, `models.layers.FoldedGroupNorm`) apply the folded affine
themselves. The split matters there: one 1024² VAE frame has only 32 groups
of 4.19 M elements each.

K3's `triton` is imported on the first CUDA launch only: its kernels below
are plain functions until `_compiled()` binds `tl` and wraps them in
`triton.jit`.

Training: when x, γ or β needs a gradient, `group_norm` runs as an autograd
Function that saves x, γ and β. Its backward is `group_norm_backward`, plain
PyTorch that recomputes the statistics from the saved x in fp32, as the JAX
custom VJP does (hi3d_tpu/ops/group_norm.py:_group_norm_act_bwd: the Pallas
kernels are forward-only there too).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build

tl = None  # bound to triton.language on the first CUDA launch
_STATS = None
_APPLY = None

BLOCK = 2048
_TARGET_PROGRAMS = 1024


def _gn_stats_kernel(x_ptr, part_ptr, group_size, chunk, nsplit, BLOCK: "tl.constexpr"):
    ng = tl.program_id(0)
    sp = tl.program_id(1)
    base = ng.to(tl.int64) * group_size
    start = sp * chunk
    end = tl.minimum(start + chunk, group_size)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK], dtype=tl.float32)
    for off in range(0, chunk, BLOCK):
        idx = start + off + tl.arange(0, BLOCK)
        mask = idx < end
        xv = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
        acc += xv
        acc2 += xv * xv
    slot = (ng * nsplit + sp) * 2
    tl.store(part_ptr + slot, tl.sum(acc, axis=0))
    tl.store(part_ptr + slot + 1, tl.sum(acc2, axis=0))


def _gn_apply_kernel(x_ptr, y_ptr, w_ptr, b_ptr, part_ptr, group_size, chunk, nsplit,
                     spatial, cpg, groups, eps,
                     SILU: "tl.constexpr", BLOCK: "tl.constexpr", SPLIT_P2: "tl.constexpr"):
    ng = tl.program_id(0)
    sp = tl.program_id(1)
    parts = tl.arange(0, SPLIT_P2)
    pmask = parts < nsplit
    s1 = tl.sum(tl.load(part_ptr + (ng * nsplit + parts) * 2, mask=pmask, other=0.0), axis=0)
    s2 = tl.sum(tl.load(part_ptr + (ng * nsplit + parts) * 2 + 1, mask=pmask, other=0.0), axis=0)
    mean = s1 / group_size
    var = tl.maximum(s2 / group_size - mean * mean, 0.0)
    rstd = 1.0 / tl.sqrt(var + eps)
    c0 = (ng % groups) * cpg
    base = ng.to(tl.int64) * group_size
    start = sp * chunk
    end = tl.minimum(start + chunk, group_size)
    for off in range(0, chunk, BLOCK):
        idx = start + off + tl.arange(0, BLOCK)
        mask = idx < end
        ch = c0 + idx // spatial
        gamma = tl.load(w_ptr + ch, mask=mask, other=0.0)
        beta = tl.load(b_ptr + ch, mask=mask, other=0.0)
        xv = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
        a = gamma * rstd
        y = xv * a + (beta - mean * a)
        if SILU:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=mask)


def _compiled():
    global tl, _STATS, _APPLY
    if _STATS is None:
        import triton
        import triton.language

        tl = triton.language
        _STATS = triton.jit(_gn_stats_kernel)
        _APPLY = triton.jit(_gn_apply_kernel)
    return _STATS, _APPLY


def group_norm_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
    eps: float = 1e-5, act: Optional[str] = None,
) -> torch.Tensor:
    """Plain version with the kernel's arithmetic: one-pass fp32 moments,
    variance clamped at 0, folded affine, SiLU in fp32, then the cast."""
    n, c = x.shape[:2]
    g = num_groups
    xf = x.float().reshape(n, g, -1)
    mean = xf.mean(-1)
    var = torch.clamp((xf * xf).mean(-1) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = weight.float().reshape(1, g, c // g) * rstd[:, :, None]
    b = bias.float().reshape(1, g, c // g) - mean[:, :, None] * a
    y = xf.reshape(n, g, c // g, -1) * a[..., None] + b[..., None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return y.reshape(x.shape).to(x.dtype)


def group_norm_backward(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dy: torch.Tensor,
    num_groups: int, eps: float = 1e-5, act: Optional[str] = None,
):
    """(dx, dγ, dβ) of `group_norm` for the cotangent `dy`: fp32 recompute of
    the forward's one-pass statistics, then the per-group GroupNorm backward
    (through the SiLU when `act` is "silu"); results in the inputs' dtypes."""
    n, c = x.shape[:2]
    g = num_groups
    xf = x.float().reshape(n, g, -1)
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(n, c, -1)
    wf = weight.float()[None, :, None]
    dz = dy.float().reshape(n, c, -1)
    if act == "silu":
        z = xhat * wf + bias.float()[None, :, None]
        sig = torch.sigmoid(z)
        dz = dz * sig * (1.0 + z * (1.0 - sig))
    elif act is not None:
        raise ValueError(f"unknown activation {act!r}")
    dweight = (dz * xhat).sum((0, 2))
    dbias = dz.sum((0, 2))
    dxhat = (dz * wf).reshape(n, g, -1)
    xhat = xhat.reshape(n, g, -1)
    m = xhat.shape[-1]
    s1 = dxhat.sum(-1, keepdim=True)
    s2 = (dxhat * xhat).sum(-1, keepdim=True)
    dx = rstd * (dxhat - (s1 + xhat * s2) / m)
    return dx.reshape(x.shape).to(x.dtype), dweight.to(weight.dtype), dbias.to(bias.dtype)


def _check_groups(x: torch.Tensor, num_groups: int, name: str) -> int:
    """Checks a CUDA (N, C, *spatial) tensor for K3 or #9; returns the
    group size (C/G)·prod(spatial)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.ndim < 3:
        raise ValueError(f"{name}: needs a contiguous (N, C, *spatial) tensor, got {tuple(x.shape)}")
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{name}: C={c} not divisible by {num_groups} groups")
    group_size = (c // num_groups) * (x.numel() // (n * c))
    if group_size >= 2**31:
        raise ValueError(f"{name}: group of {group_size} elements exceeds int32 indexing")
    return group_size


def _partial_sums(x: torch.Tensor, num_groups: int, name: str):
    """Checks a CUDA (N, C, *spatial) tensor and launches K3's partial-sum
    pass: returns the (N·G, nsplit, 2) fp32 partials and the split geometry
    (group_size, chunk, nsplit)."""
    group_size = _check_groups(x, num_groups, name)
    ngroups = x.shape[0] * num_groups
    nsplit = max(1, min(-(-group_size // BLOCK), -(-_TARGET_PROGRAMS // ngroups)))
    chunk = -(-(-(-group_size // nsplit)) // BLOCK) * BLOCK
    nsplit = -(-group_size // chunk)
    stats = _compiled()[0]
    part = torch.empty((ngroups, nsplit, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stats[(ngroups, nsplit)](x, part, group_size, chunk, nsplit, BLOCK=BLOCK, num_warps=8)
    return part, group_size, chunk, nsplit


def _split_p2(nsplit: int) -> int:
    return max(2, 1 << (nsplit - 1).bit_length())


def _forward(x, weight, bias, num_groups, eps, act):
    if x.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return group_norm_reference(x, weight, bias, num_groups, eps, act)
    if act not in (None, "silu"):
        raise ValueError(f"unknown activation {act!r}")
    part, group_size, chunk, nsplit = _partial_sums(x, num_groups, "group_norm")
    n, c = x.shape[:2]
    w = weight.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    apply = _compiled()[1]
    with torch.cuda.device(x.device):
        apply[part.shape[:2]](
            x, y, w, b, part, group_size, chunk, nsplit, x.numel() // (n * c),
            c // num_groups, num_groups, float(eps), SILU=act == "silu", BLOCK=BLOCK,
            SPLIT_P2=_split_p2(nsplit), num_warps=8,
        )
    group_norm.launches += 1
    return y


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        y = _forward(x, weight, bias, num_groups, eps, act)
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps, act)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        return (*group_norm_backward(x, weight, bias, dy, *ctx.args), None, None, None)


def group_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
    eps: float = 1e-5, act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over (N, C, *spatial) with optional fused SiLU."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _GroupNorm.apply(x, weight, bias, num_groups, eps, act)
    return _forward(x, weight, bias, num_groups, eps, act)


group_norm.launches = 0


def group_stats_reference(x: torch.Tensor, num_groups: int,
                          eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of #9: fp32 (N, G) mean and inv_std of (N, C, *spatial),
    one-pass moments, variance clamped at 0 (`_group_stats`)."""
    xf = x.float().reshape(x.shape[0], num_groups, -1)
    mean = xf.mean(-1)
    var = torch.clamp((xf * xf).mean(-1) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


# #9's launch geometry (csrc/norm_stats.cu): CTAs of 256 threads, clusters of
# at most 8 (the portable size), about two CTAs an SM of an H100's 132, and a
# CTA no smaller than MIN_CTA_ELEMENTS unless its whole group is
MAX_CLUSTER = 8
TARGET_CTAS = 2 * 132
MIN_CTA_ELEMENTS = 1 << 14


@functools.lru_cache(maxsize=256)
def plan_group_stats(groups: int, group_size: int, vec: int) -> Tuple[int, int]:
    """(cluster, chunk) for #9 on `groups` groups of `group_size` elements:
    the CTAs a group (a power of two up to MAX_CLUSTER, doubled while the
    grid stays within TARGET_CTAS and every CTA keeps MIN_CTA_ELEMENTS), and
    the elements a CTA owns, a multiple of `vec` (the elements in 16 bytes)
    so that the slices of a 16-byte aligned group start aligned. Rank r of a
    group owns [min(r·chunk, group_size), min((r + 1)·chunk, group_size))."""
    cluster = 1
    while (cluster < MAX_CLUSTER and groups * cluster * 2 <= TARGET_CTAS
           and group_size >= cluster * 2 * MIN_CTA_ELEMENTS):
        cluster *= 2
    chunk = -(-(-(-group_size // cluster)) // vec) * vec
    return cluster, chunk


def group_stats(x: torch.Tensor, num_groups: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 per-group (mean, inv_std), each (N, G), of a contiguous
    (N, C, *spatial) tensor: #9 (one launch) on CUDA tensors,
    `group_stats_reference` on CPU tensors. No gradient flows through the
    statistics themselves; `models.layers.FoldedGroupNorm` carries the
    GroupNorm backward."""
    if x.device.type == "cpu":
        return group_stats_reference(x, num_groups, eps)
    group_size = _check_groups(x, num_groups, "group_stats")
    n = x.shape[0]
    groups = n * num_groups
    cluster, chunk = plan_group_stats(groups, group_size, 16 // x.element_size())
    stats = torch.empty((2, n, num_groups), dtype=torch.float32, device=x.device)
    ptr = stats.data_ptr()
    err = build.launch(build.load_library().hi3d_group_stats, x.get_device(), x.data_ptr(), ptr,
                       ptr + 4 * groups, groups, group_size, chunk, cluster,
                       build.DTYPE_CODES[x.dtype], eps)
    build.check(err, "group_stats")
    group_stats.launches += 1
    mean, inv = stats.unbind(0)
    return mean, inv


group_stats.launches = 0
