"""K3: GroupNorm(+SiLU) forward, and #9: GroupNorm statistics alone.

Replaces hi3d_tpu/ops/group_norm.py:_fused_group_norm_nsc (Pallas
`_stats_kernel` + `_apply_kernel`, reached through `fused_group_norm` /
`GroupNorm32`): per-group Σx and Σx² in fp32, mean and variance (clamped at
0, as `_group_stats` does), the folded affine a = γ·σ⁻¹, b = β − μ·a, and
y = act(x·a + b) in fp32 with the optional SiLU applied before the cast.

K3 is CUDA C++ (`csrc/group_norm.cu`, built by `build.py`), one launch a
call, whose notes say what bounds it on the H100 (one read of x and one
write of y: memory bandwidth) and how the design answers. It takes x as an
(N, C, S1, S2) view, S2 the innermost run of unit stride (`_layout`), so
the UNet's time stack hands it the (B, C, T, H, W) permuted view of a
(B, T, C, H, W) tensor with no copy; y is contiguous. A group goes to a
thread-block cluster of 1–8 CTAs. Where there are thousands of groups (the
2-D norms) each CTA keeps its share in shared memory and x is read from HBM
once; where there are few, large groups (the time stacks) the CTAs stream
their shares twice. `plan_group_norm` makes that choice. The CTAs of a
cluster fold their partial sums through distributed shared memory (no
scratch tensor, no atomics: repeatable bit for bit).

#9 replaces hi3d_tpu/ops/group_norm.py:_pallas_group_stats_impl (Pallas
`_gstats_kernel`, reached through `pallas_group_stats` under HI3D_GN=pallas):
fp32 per-group (mean, inv_std) of shape (N, G), one-pass and clamped as
above. It is CUDA C++ (`csrc/norm_stats.cu`), one launch a call: a
thread-block cluster of 1–8 CTAs a group streams the group's slices, and
its rank 0 folds the partial sums through the same distributed-shared-memory
fold as K3. The cluster size comes from `plan_group_stats`. Its callers (the
VAE's and the DPT's fp32 GroupNorms, `models.layers.FoldedGroupNorm`) apply
the folded affine themselves. The split matters there: one 1024² VAE frame
has only 32 groups of 4.19 M elements each.

Split groups: the frame-parallel UNet's time stacks hold, on each rank of a
process group, every frame of a block of the locations, so a group's
statistics span the ranks. `group_moments` is #9 in its moments mode: this
tensor's fp32 (mean, M2) a group, two passes over x (M2 = Σ(x − mean)², not
Σx² − n·mean², so that the ranks' moments combine exactly, by Chan's
formula in `parallel.dist.FrameShard.combine_moments`). `group_norm_apply`
is K3 with the combined statistics given: one launch that reads x once and
writes y, with the same folded affine and SiLU. Each has a plain version
that CPU tensors take, and counts its launches in its kernel's counter
(`group_stats.launches`, `group_norm.launches`).

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


# #9's and K3's launch geometry (csrc/norm_stats.cu, csrc/group_norm.cu):
# clusters of at most 8 CTAs (the portable size), about two CTAs an SM of an
# H100's SM_COUNT, and a #9 CTA (256 threads) no smaller than
# MIN_CTA_ELEMENTS unless its whole group is
MAX_CLUSTER = 8
SM_COUNT = 132
TARGET_CTAS = 2 * SM_COUNT
MIN_CTA_ELEMENTS = 1 << 14


def _check_groups(x: torch.Tensor, num_groups: int, name: str) -> int:
    """Checks a contiguous CUDA (N, C, *spatial) tensor for #9; returns the
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


# K3's (csrc/group_norm.cu). With at least TARGET_CTAS groups (the 2-D
# norms: N·G in the thousands), a group goes to one CTA up to SOLO_BYTES,
# else to the cluster that leaves each CTA at most SLICE_BYTES, and each CTA
# keeps its share in shared memory (one read of x) up to RESIDENT_BYTES.
# With fewer groups (the time stacks: B·G ≤ 128 groups of 0.08–5 MB), the
# CTAs are 1024 threads, one an SM, as many as fill SM_COUNT SMs once, and
# they stream their shares twice (the second read, in reverse, partly from
# L2). Both regimes were the fastest of the clusters, shares and thread
# counts timed on the H100 at the main paths' shapes.
SOLO_BYTES = 96 * 1024
SLICE_BYTES = 48 * 1024
RESIDENT_BYTES = 200 * 1024
# An SM's shared memory (1 KB of it reserved a CTA) and the threads its
# registers hold at K3's 64 a thread: a CTA gets 1024 threads where its
# shared memory leaves room for one CTA an SM, 512 for two, else 256.
SM_SHARED_BYTES = 228 * 1024
SM_THREADS = 1024


@functools.lru_cache(maxsize=256)
def plan_group_norm(groups: int, gvecs: int, vec_bytes: int,
                    cpg: int) -> Tuple[int, int, int, int]:
    """(cluster, chunk, res, threads) for K3 on `groups` groups of `gvecs`
    accesses of `vec_bytes` bytes each (16-byte vectors, or single
    elements) and `cpg` channels: the CTAs a group (a power of two up to
    MAX_CLUSTER), the accesses a CTA owns (rank r: [min(r·chunk, gvecs),
    min((r + 1)·chunk, gvecs))), how many of those it keeps in shared memory
    beside its per-channel coefficients, and the threads a CTA; the two
    regimes are described above."""
    gbytes = gvecs * vec_bytes
    cluster = 1
    if groups < TARGET_CTAS:
        while cluster < MAX_CLUSTER and groups * cluster * 2 <= SM_COUNT:
            cluster *= 2
        return cluster, -(-gvecs // cluster), 0, SM_THREADS
    if gbytes > SOLO_BYTES:
        while cluster < MAX_CLUSTER and gbytes > cluster * SLICE_BYTES:
            cluster *= 2
    chunk = -(-gvecs // cluster)
    res = min(chunk, max(0, RESIDENT_BYTES - 8 * cpg) // vec_bytes)
    smem = -(-res * vec_bytes // 16) * 16 + 8 * cpg + 1024
    per_sm = max(1, min(SM_THREADS // 256, SM_SHARED_BYTES // smem))
    threads = SM_THREADS // per_sm if per_sm < 3 else 256
    return cluster, chunk, res, threads


def _layout(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(S1, S2, S1 stride) of an (N, C, *spatial) tensor seen as the
    (N, C, S1, S2) view K3 reads: S2 the trailing dims that form one run of
    unit stride, S1 the leading spatial dims merged into one strided axis;
    None when they do not merge (then K3 needs a copy)."""
    shape, stride = x.shape[2:], x.stride()[2:]
    i, s2 = len(shape) - 1, 1
    while i >= 0 and (shape[i] == 1 or stride[i] == s2):
        s2 *= shape[i]
        i -= 1
    s1, ss1 = 1, 0
    for j in range(i, -1, -1):
        if shape[j] == 1:
            continue
        if s1 == 1:
            s1, ss1 = shape[j], stride[j]
        elif stride[j] == ss1 * s1:
            s1 *= shape[j]
        else:
            return None
    return s1, s2, ss1


def _strides(x: torch.Tensor, s1: int, ss1: int) -> Tuple[int, int, int]:
    """x's (n, c, s1) element strides, 0 along an axis of extent 1."""
    n, c = x.shape[:2]
    return (x.stride(0) if n > 1 else 0, x.stride(1) if c > 1 else 0, ss1 if s1 > 1 else 0)


def _vectorized(x: torch.Tensor, layout) -> bool:
    """Whether K3 reads x in 16-byte vectors: an aligned base, and S2 and
    the (n, c, s1) strides whole vectors."""
    per = 16 // x.element_size()
    s1, s2, ss1 = layout
    return (x.data_ptr() % 16 == 0 and s2 % per == 0
            and not any(st % per for st in _strides(x, s1, ss1)))


def reads_in_place(x: torch.Tensor) -> bool:
    """Whether K3 reads x as it lies, in 16-byte vectors; `GroupNorm32`
    copies x to contiguous first otherwise."""
    layout = _layout(x) if x.ndim >= 3 else None
    return layout is not None and _vectorized(x, layout)


def _launch(x, weight, bias, num_groups, eps, act, stats=None):
    """One K3 launch on a CUDA tensor, as `plan_group_norm` plans it; with
    `stats` ((2, N, G) fp32 mean and inv_std) it applies those instead of
    computing them, keeping nothing in shared memory."""
    if not x.is_cuda:
        raise ValueError(f"group_norm: unsupported device {x.device}")
    code = build.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"group_norm: unsupported dtype {x.dtype}")
    if act not in (None, "silu"):
        raise ValueError(f"unknown activation {act!r}")
    if x.ndim < 3:
        raise ValueError(f"group_norm: needs an (N, C, *spatial) tensor, got {tuple(x.shape)}")
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"group_norm: C={c} not divisible by {num_groups} groups")
    layout = _layout(x)
    if layout is None:
        raise ValueError(f"group_norm: strides {x.stride()} of {tuple(x.shape)} do not form "
                         "(N, C, S1, S2) with a unit-stride S2")
    s1, s2, ss1 = layout
    vec = _vectorized(x, layout)
    per = 16 // x.element_size() if vec else 1
    cpg = c // num_groups
    gvecs = cpg * s1 * (s2 // per)
    if gvecs >= 2**31:
        raise ValueError(f"group_norm: a group of {gvecs} accesses exceeds int32 indexing")
    w_code = build.DTYPE_CODES.get(weight.dtype)
    if w_code is None or weight.shape != (c,) or bias.shape != (c,):
        raise TypeError(f"group_norm: γ {weight.dtype}{tuple(weight.shape)}, β "
                        f"{bias.dtype}{tuple(bias.shape)} for C={c}")
    dev = x.get_device()
    if weight.get_device() != dev or bias.get_device() != dev:
        raise ValueError(f"group_norm: γ on {weight.device}, β on {bias.device}, x on {x.device}")
    # the contiguous γ/β stay bound to these names until the launch has returned
    weight = weight.detach().contiguous()
    bias = bias.detach().to(weight.dtype).contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    cluster, chunk, res, threads = plan_group_norm(n * num_groups, gvecs, per * x.element_size(),
                                                   cpg)
    stats_ptr = None
    if stats is not None:
        if (stats.dtype != torch.float32 or stats.shape != (2, n, num_groups)
                or not stats.is_contiguous() or stats.get_device() != dev):
            raise ValueError(f"group_norm: given statistics {stats.dtype}{tuple(stats.shape)} on "
                             f"{stats.device}, want contiguous float32 (2, {n}, {num_groups}) "
                             f"on {x.device}")
        res, stats_ptr = 0, stats.data_ptr()
    err = build.launch(build.load_library().hi3d_group_norm, dev, x.data_ptr(), y.data_ptr(),
                       weight.data_ptr(), bias.data_ptr(), n, c, num_groups, s1, s2,
                       *_strides(x, s1, ss1), code, w_code, int(vec), cluster, chunk, res,
                       threads, float(eps), int(act == "silu"), stats_ptr)
    build.check(err, "group_norm")
    return y


def _forward(x, weight, bias, num_groups, eps, act):
    if x.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return group_norm_reference(x, weight, bias, num_groups, eps, act)
    y = _launch(x, weight, bias, num_groups, eps, act)
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
    """GroupNorm over (N, C, *spatial) with optional fused SiLU: K3 (one
    launch) on CUDA tensors in any layout `_layout` takes, output
    contiguous; `group_norm_reference` on CPU tensors."""
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
    return _stats_launch(x, num_groups, eps, moments=False)


def _stats_launch(x: torch.Tensor, num_groups: int, eps: float,
                  moments: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One #9 launch on a contiguous CUDA tensor: (mean, inv_std), or with
    `moments` (mean, M2), each (N, G) fp32."""
    group_size = _check_groups(x, num_groups, "group_moments" if moments else "group_stats")
    n = x.shape[0]
    groups = n * num_groups
    cluster, chunk = plan_group_stats(groups, group_size, 16 // x.element_size())
    stats = torch.empty((2, n, num_groups), dtype=torch.float32, device=x.device)
    ptr = stats.data_ptr()
    err = build.launch(build.load_library().hi3d_group_stats, x.get_device(), x.data_ptr(), ptr,
                       ptr + 4 * groups, groups, group_size, chunk, cluster,
                       build.DTYPE_CODES[x.dtype], eps, int(moments))
    build.check(err, "group_stats")
    group_stats.launches += 1
    first, second = stats.unbind(0)
    return first, second


group_stats.launches = 0


def group_moments_reference(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of #9's moments mode: fp32 (N, G) mean and M2 = Σ(x −
    mean)² of (N, C, *spatial), two passes."""
    xf = x.float().reshape(x.shape[0], num_groups, -1)
    mean = xf.mean(-1)
    return mean, ((xf - mean[..., None]) ** 2).sum(-1)


def group_moments(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 per-group (mean, M2), each (N, G), of a contiguous (N, C,
    *spatial) tensor: #9 in its moments mode (one launch, counted in
    `group_stats.launches`) on CUDA tensors, `group_moments_reference` on
    CPU tensors. The moments of a group split over ranks combine in
    `parallel.dist.FrameShard.combine_moments`."""
    if x.device.type == "cpu":
        return group_moments_reference(x, num_groups)
    return _stats_launch(x, num_groups, 0.0, moments=True)


def group_norm_apply_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                               num_groups: int, stats: torch.Tensor,
                               act: Optional[str] = None) -> torch.Tensor:
    """Plain version of K3 with given statistics (`stats`: (2, N, G) fp32
    mean and inv_std): the folded affine a = γ·inv, b = β − mean·a per
    (sample, channel), y = act(x·a + b) in fp32, then the cast."""
    n, c = x.shape[:2]
    g = num_groups
    mean, inv_std = stats[0], stats[1]
    a = weight.float().reshape(1, g, c // g) * inv_std[:, :, None]
    b = bias.float().reshape(1, g, c // g) - mean[:, :, None] * a
    y = x.float().reshape(n, g, c // g, -1) * a[..., None] + b[..., None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return y.reshape(x.shape).to(x.dtype)


def group_norm_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                     stats: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) of (N, C, *spatial) with given statistics (`stats`:
    contiguous (2, N, G) fp32, the mean and inv_std of each group): K3
    without its statistics pass (one launch, counted in
    `group_norm.launches`) on CUDA tensors, output contiguous;
    `group_norm_apply_reference` on CPU tensors. Forward only."""
    if x.device.type == "cpu":
        return group_norm_apply_reference(x, weight, bias, num_groups, stats, act)
    y = _launch(x, weight, bias, num_groups, 0.0, act, stats=stats)
    group_norm.launches += 1
    return y
