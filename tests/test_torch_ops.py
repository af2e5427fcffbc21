"""The port's kernels' plain versions against the JAX package, on CPU, plus
the stdlib image IO.

K1 (flash attention), K2 (temporal attention), K3 (GroupNorm), #9 (GroupNorm
statistics) and #10 (LayerNorm row statistics) each have a plain PyTorch
version that a CPU tensor takes; here those are held against the Pallas
kernels in interpret mode (K1, K2, #9, #10) or against the JAX GroupNorm
paths (the fused Pallas GN has no interpret mode; its plain reference is the
comparison point). The same holds for the backward passes: the port's
autograd Functions on CPU tensors run the plain versions of #3 / #5 / K3's
backward, held against `jax.grad` through the JAX custom VJPs (Pallas
backward kernels in interpret mode for #3 and #5, the XLA recompute for
GroupNorm). Inputs come from numpy.random.RandomState. The kernels
themselves are checked on the card by tests/test_torch_gpu.py.
"""

import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hi3d_tpu_torch.ops import attention as attn_ops
from hi3d_tpu_torch.ops import flash_attention as fa
from hi3d_tpu_torch.ops import group_norm as gn
from hi3d_tpu_torch.ops import layer_norm as ln
from hi3d_tpu_torch.ops import temporal_attention as ta

# fp32 on both sides: differences are summation order only
ATTN_ATOL = 2e-5
GN_ATOL = 2e-5


@pytest.mark.parametrize("b,s,h,d,packed", [
    (2, 128, 2, 64, False),
    (1, 96, 3, 64, True),   # (B, S, H·D) projection output read as a strided view
    (2, 64, 2, 80, True),
])
def test_flash_attention_plain_matches_pallas(b, s, h, d, packed):
    from hi3d_tpu.ops.flash_attention import flash_attention as jax_flash

    rnd = np.random.RandomState(0)
    qkv = rnd.randn(b, s, 3 * h * d).astype(np.float32)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d) for i in range(3))
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    if packed:
        t = torch.from_numpy(qkv)
        tq, tk, tv = (t[..., i * h * d:(i + 1) * h * d].view(b, s, h, d) for i in range(3))
        assert not tq.is_contiguous()
    else:
        tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v))
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(tq, tk, tv)
    assert fa.flash_attention.launches == before  # CPU tensors never count a launch
    np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_ATOL, rtol=0)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * d**-0.5
    ref_lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-4, rtol=0)


def test_flash_attention_ragged_matches_xla():
    """S that no block divides (the kernel masks it) against the XLA path."""
    from hi3d_tpu.ops.attention import xla_attention

    rnd = np.random.RandomState(1)
    q, k, v = (rnd.randn(2, 77, 2, 64).astype(np.float32) for _ in range(3))
    ref = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out, _ = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("t", [16, 5])
def test_temporal_attention_plain_matches_pallas_and_xla(t):
    from hi3d_tpu.ops.attention import xla_attention_time
    from hi3d_tpu.ops.temporal_attention import temporal_attention_natural

    rnd = np.random.RandomState(2)
    b, s, h, d = 2, 16, 2, 64
    q, k, v = (rnd.randn(b, t, s, h, d).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out = ta.temporal_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(out, np.asarray(xla_attention_time(jq, jk, jv)),
                               atol=ATTN_ATOL, rtol=0)
    if t == 16:
        nat = np.asarray(temporal_attention_natural(jq, jk, jv))
        np.testing.assert_allclose(out, nat, atol=ATTN_ATOL, rtol=0)


def test_temporal_attention_stride_rule_takes_the_unet_projections():
    """K2 copies 16 bytes at a time, so its wrapper takes (b, t, s) strides
    of whole 8-element vectors on an aligned base: the UNet's projections
    (`to_q(x).view(b, t, s, h, d)`, a fresh Linear output, and q, k, v cut
    from one packed qkv at the channel widths 320/640/1280) meet that rule;
    a view 2 elements off it does not, and the backward (#5, bf16 pairs)
    still takes it."""
    b, t, s = 2, 4, 3
    for c in (320, 640, 1280):
        x = torch.randn((b * t * s, 32))
        proj = torch.nn.Linear(32, c, bias=False)(x).view(b, t, s, c // 64, 64)
        assert ta._packed(proj, ta.K2_ALIGN)
        qkv = torch.randn((b, t, s, 3 * c))
        for i in range(3):
            assert ta._packed(qkv[..., i * c:(i + 1) * c].unflatten(-1, (c // 64, 64)),
                              ta.K2_ALIGN)
        off = torch.randn((b, t, s, c + 2))[..., 2:].unflatten(-1, (c // 64, 64))
        assert not ta._packed(off, ta.K2_ALIGN) and ta._packed(off, 2)


def test_temporal_attention_backward_copies_only_operands_off_the_rule():
    """#5 copies 16 bytes at a time like K2; its wrapper passes an operand
    that meets K2's rule as it is (a UNet projection, q cut from a packed
    qkv, a transposed view whose strides are whole 8-element vectors) and
    copies one that does not (a view 2 elements off the rule, the same view
    transposed, a contiguous tensor on a base 2 bytes off) into contiguous
    memory that meets it, with the same values."""
    b, t, s, c = 2, 4, 3, 320
    bf16 = torch.bfloat16

    def heads(x):
        return x.unflatten(-1, (c // 64, 64))

    proj = heads(torch.randn((b * t * s, c), dtype=bf16).view(b, t, s, c))
    qkv = heads(torch.randn((b, t, s, 3 * c), dtype=bf16)[..., c:2 * c])
    swapped = heads(torch.randn((b, s, t, c), dtype=bf16).transpose(1, 2))
    for x in (proj, qkv, swapped):
        assert ta._aligned(x) is x
    off = heads(torch.randn((b, t, s, c + 2), dtype=bf16)[..., 2:])
    off_swapped = heads(torch.randn((b, s, t, c + 2), dtype=bf16)[..., 2:].transpose(1, 2))
    shifted = torch.randn((b * t * s * c + 1,), dtype=bf16)[1:].view(b, t, s, c // 64, 64)
    for x in (off, off_swapped, shifted):
        assert not ta._packed(x)
        y = ta._aligned(x)
        assert y.is_contiguous() and ta._packed(y) and torch.equal(y, x)


def test_time_cross_attention_matches_xla():
    from hi3d_tpu.ops.attention import xla_attention_time

    rnd = np.random.RandomState(3)
    q = rnd.randn(2, 4, 6, 2, 16).astype(np.float32)
    for sk in (1, 3):
        k, v = (rnd.randn(2, sk, 2, 16).astype(np.float32) for _ in range(2))
        ref = np.asarray(xla_attention_time(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        out = attn_ops.time_cross_attention(*(torch.from_numpy(a) for a in (q, k, v)))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_ATOL, rtol=0)


def test_cross_attention_matches_xla():
    from hi3d_tpu.ops.attention import dot_product_attention

    rnd = np.random.RandomState(4)
    q = rnd.randn(2, 10, 2, 16).astype(np.float32)
    for sk in (1, 7):
        k, v = (rnd.randn(2, sk, 2, 16).astype(np.float32) for _ in range(2))
        ref = np.asarray(dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               backend="xla"))
        out = attn_ops.cross_attention(*(torch.from_numpy(a) for a in (q, k, v)))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("shape,act", [
    ((3, 64, 5, 6), None),
    ((3, 64, 5, 6), "silu"),
    ((2, 40, 4, 3, 5), "silu"),  # 5-D time-stack layout (N, C, T, H, W)
])
def test_group_norm_plain_matches_jax(shape, act):
    from hi3d_tpu.models.layers import GroupNorm32
    from hi3d_tpu.ops.group_norm import _xla_group_norm

    rnd = np.random.RandomState(5)
    x = (rnd.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[1]
    w = rnd.randn(c).astype(np.float32)
    b = rnd.randn(c).astype(np.float32)
    xl = jnp.asarray(np.moveaxis(x, 1, -1))  # channels-last for JAX
    groups = int(np.gcd(c, 32))
    ref = np.moveaxis(np.asarray(_xla_group_norm(xl, jnp.asarray(w), jnp.asarray(b),
                                                 groups, 1e-5, act)), -1, 1)
    params = {"params": {"norm": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}}
    mod_ref = np.moveaxis(np.asarray(GroupNorm32(act=act).apply(params, xl)), -1, 1)
    out = gn.group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                        groups, 1e-5, act).numpy()
    np.testing.assert_allclose(out, ref, atol=GN_ATOL, rtol=0)
    np.testing.assert_allclose(out, mod_ref, atol=GN_ATOL, rtol=0)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm32_reads_the_time_stack_view(act):
    """`GroupNorm32` hands K3 the (B, C, T, H, W) permuted view of a
    (B, T, C, H, W) tensor as it lies (K3 reads it in place, in 16-byte
    vectors), and its output matches JAX's `_xla_group_norm` on the same
    numpy data, with and without SiLU (fp32 on both sides: GN_ATOL)."""
    from hi3d_tpu.ops.group_norm import _xla_group_norm
    from hi3d_tpu_torch.models import layers

    rnd = np.random.RandomState(7)
    b, t, c, h, w = 2, 3, 64, 4, 4
    x = (rnd.randn(b, t, c, h, w) * 2 + 0.5).astype(np.float32)
    gamma, beta = rnd.randn(c).astype(np.float32), rnd.randn(c).astype(np.float32)
    view = torch.from_numpy(x).permute(0, 2, 1, 3, 4)
    assert gn.reads_in_place(view) and gn._layout(view) == (t, h * w, c * h * w)
    seen = []
    real = layers.group_norm
    norm = layers.GroupNorm32(c, act=act)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(gamma))
        norm.bias.copy_(torch.from_numpy(beta))
    try:
        layers.group_norm = lambda x_, *a: seen.append(x_) or real(x_, *a)
        out = norm(view).detach().numpy()
    finally:
        layers.group_norm = real
    assert seen[0] is view
    xl = jnp.asarray(np.moveaxis(x, 2, -1))  # (B, T, H, W, C) for JAX
    ref = np.asarray(_xla_group_norm(xl, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5, act))
    np.testing.assert_allclose(out, np.moveaxis(ref, -1, 1), atol=GN_ATOL, rtol=0)


def _k3_offsets(x: torch.Tensor, num_groups: int, plan):
    """The x and y element offsets K3's index math (csrc/group_norm.cu
    `locate`) visits for each group under `plan`, each access widened to
    its elements: {group: (x offsets, y offsets)}."""
    n, c = x.shape[:2]
    s1, s2, ss1 = gn._layout(x)
    vec = gn._vectorized(x, (s1, s2, ss1))
    per = 16 // x.element_size() if vec else 1
    sn, sc, ss1 = gn._strides(x, s1, ss1)
    cpg = c // num_groups
    vpr = s2 // per
    gvecs = cpg * s1 * vpr
    cluster, chunk, _, _ = plan
    out = {}
    for grp in range(n * num_groups):
        i, g = divmod(grp, num_groups)
        xs, ys = [], []
        for rank in range(cluster):
            e0 = min(rank * chunk, gvecs)
            e = np.arange(e0, min(e0 + chunk, gvecs))
            row, j = np.divmod(e, vpr)
            t, cl = np.divmod(row, cpg)
            xo = i * sn + (g * cpg + cl) * sc + t * ss1 + j * per
            yo = ((i * c + g * cpg + cl) * s1 + t) * s2 + j * per
            xs.append((xo[:, None] + np.arange(per)).ravel())
            ys.append((yo[:, None] + np.arange(per)).ravel())
        out[grp] = np.concatenate(xs), np.concatenate(ys)
    return out


@pytest.mark.parametrize("layout", ["nchw", "ncthw", "time_stack_view", "channels_last",
                                    "rows_of_5"])
def test_group_norm_index_math_covers_each_group_once(layout):
    """K3's (N, C, S1, S2) reading of a layout, with a plan that splits each
    group over a cluster of 4: the x elements visited for a group are
    exactly that group's elements of the view, each once, and the y
    offsets are the group's run of a contiguous y, each once."""
    base = {"nchw": lambda: torch.zeros((2, 64, 4, 8)),
            "ncthw": lambda: torch.zeros((2, 64, 3, 4, 8)),
            "time_stack_view": lambda: torch.zeros((2, 3, 64, 4, 8)).permute(0, 2, 1, 3, 4),
            "channels_last": lambda: torch.zeros((2, 4, 8, 64)).permute(0, 3, 1, 2),
            "rows_of_5": lambda: torch.zeros((2, 64, 3, 5))}[layout]()
    x = base.to(torch.bfloat16)
    assert gn._layout(x) is not None
    assert gn.reads_in_place(x) == (layout in ("nchw", "ncthw", "time_stack_view"))
    storage = torch.arange(x.untyped_storage().nbytes() // 2).as_strided(x.shape, x.stride())
    n, c = x.shape[:2]
    s1, s2, _ = gn._layout(x)
    per = 8 if gn.reads_in_place(x) else 1
    gvecs = (c // 32) * s1 * s2 // per
    chunk = -(-gvecs // 4)
    for grp, (xo, yo) in _k3_offsets(x, 32, (4, chunk, chunk, 256)).items():
        i, g = divmod(grp, 32)
        want = storage[i, g * 2:(g + 1) * 2].flatten().numpy()
        assert np.array_equal(np.sort(xo), np.sort(want))
        gsize = want.size
        assert np.array_equal(np.sort(yo), np.arange(grp * gsize, (grp + 1) * gsize))


# the main paths' K3 shapes (bf16): the 2-D norms at 64², 32², 16², 8² (a
# stage-1 UNet call, 2 × 16 frames) and at 128² (stage 2), the time stacks at
# 16 and 48 frames (stage 1, the 48-frame training clip), the serve batch (4
# videos × 48 frames) and stage 2's time stack
K3_MAIN_SHAPES = [(32, 320, 64, 64), (32, 640, 32, 32), (32, 1280, 16, 16), (32, 1280, 8, 8),
                  (32, 320, 128, 128), (32, 640, 64, 64), (192, 320, 64, 64),
                  (2, 320, 16, 64, 64), (2, 1280, 16, 8, 8), (1, 320, 48, 64, 64),
                  (4, 320, 48, 64, 64), (4, 1280, 48, 16, 16), (2, 320, 16, 128, 128)]


@pytest.mark.parametrize("shape", K3_MAIN_SHAPES)
def test_group_norm_plan_at_main_path_shapes(shape):
    """`plan_group_norm` at every main-path shape: a cluster of 1–8 CTAs (a
    power of two) whose 16-byte vectors cover the group exactly once. The
    2-D norms (thousands of groups) keep each CTA's whole share in shared
    memory (one read of x): a group a CTA up to SOLO_BYTES, else shares of
    at most SLICE_BYTES, and the threads that let the SM hold SM_THREADS of
    them. The time stacks (at most 128 groups) stream their shares with
    1024-thread CTAs, at most one an SM."""
    n, c = shape[:2]
    cpg = c // 32
    gvecs = cpg * int(np.prod(shape[2:])) // 8
    cluster, chunk, res, threads = gn.plan_group_norm(n * 32, gvecs, 16, cpg)
    assert 1 <= cluster <= gn.MAX_CLUSTER and cluster & (cluster - 1) == 0
    assert chunk * cluster >= gvecs and (chunk - 1) * cluster < gvecs
    covered = np.zeros(gvecs, dtype=np.int64)
    for r in range(cluster):
        start = min(r * chunk, gvecs)
        covered[start:min(start + chunk, gvecs)] += 1
    assert (covered == 1).all()
    if len(shape) == 5:  # a time stack
        assert (res, threads) == (0, gn.SM_THREADS)
        assert n * 32 * cluster <= gn.SM_COUNT < n * 32 * cluster * 2 or cluster == 8
        return
    assert res == chunk  # resident: one read of x
    assert chunk * 16 <= (gn.SOLO_BYTES if cluster == 1 else gn.SLICE_BYTES)
    smem = res * 16 + 8 * cpg
    per_sm = min(4, gn.SM_SHARED_BYTES // (smem + 1024))
    assert threads in (256, 512, 1024) and threads * per_sm <= gn.SM_THREADS


def test_group_norm_clamps_variance_on_near_constant_input():
    """A near-constant group makes the one-pass E[x²] − mean² negative in
    fp32; the clamp (as hi3d_tpu.ops.group_norm._group_stats) keeps the
    result finite, ≈ β; without it rsqrt(var + eps) would be NaN."""
    from hi3d_tpu.ops.group_norm import _group_stats

    x = np.full((2, 32, 8, 8), 1000.1, np.float32)
    xt = torch.from_numpy(x)
    flat = xt.reshape(2, 32, -1)
    raw_var = (flat * flat).mean(-1) - flat.mean(-1) ** 2
    assert (raw_var < -1e-5).all(), "input does not exercise the clamp"
    w = np.linspace(0.5, 1.5, 32).astype(np.float32)
    b = np.linspace(-1, 1, 32).astype(np.float32)
    out = gn.group_norm(xt, torch.from_numpy(w), torch.from_numpy(b), 32, 1e-5).numpy()
    assert np.all(np.isfinite(out))
    mean, inv = _group_stats(jnp.asarray(np.moveaxis(x, 1, -1)), 32, 1e-5)
    assert np.all(np.isfinite(np.asarray(inv)))
    ref = (x - np.asarray(mean)[:, :, None, None]) * (np.asarray(inv)[:, :, None, None]
                                                       * w[:, None, None]) + b[:, None, None]
    np.testing.assert_allclose(out, ref, atol=0.1, rtol=0)
    np.testing.assert_allclose(out, np.broadcast_to(b[:, None, None], out.shape), atol=0.1)


# fp32 gradients through softmax backward: summation order only, on O(1)
# cotangents with O(1) gradients
GRAD_ATOL = 1e-4


def _torch_grads(fn, arrays, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    assert out.grad_fn is not None  # the autograd Function recorded the op
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(cot))]


@pytest.mark.parametrize("s,block", [(128, 64), (96, 32)])
def test_flash_attention_grad_matches_pallas_vjp(s, block):
    """#3's plain version against jax.grad through the Pallas custom VJP
    (`_bwd`: dK/dV and dQ kernels in interpret mode, several q and k blocks)."""
    import jax

    from hi3d_tpu.ops.flash_attention import flash_attention as jax_flash

    rnd = np.random.RandomState(6)
    b, h, d = 2, 2, 64
    q, k, v = (rnd.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    cot = rnd.randn(b, s, h, d).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.vdot(jax_flash(q_, k_, v_, block_q=block, block_k=block), jnp.asarray(cot))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = _torch_grads(lambda *t: fa.flash_attention(*t)[0], (q, k, v), cot)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [5, 16, 32])
def test_temporal_attention_grad_matches_pallas_vjp(t, d):
    """#5's plain version against jax.grad through `temporal_attention_natural`
    (`_nat_bwd` in interpret mode), at one and two 16-frame tiles, a ragged
    T and both head dims #5 takes."""
    import jax

    from hi3d_tpu.ops.temporal_attention import temporal_attention_natural

    rnd = np.random.RandomState(7)
    shape = (2, t, 16, 2, d)
    q, k, v, cot = (rnd.randn(*shape).astype(np.float32) for _ in range(4))

    def loss(q_, k_, v_):
        return jnp.vdot(temporal_attention_natural(q_, k_, v_), jnp.asarray(cot))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = _torch_grads(ta.temporal_attention, (q, k, v), cot)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,act", [
    ((3, 64, 5, 6), None),
    ((3, 64, 5, 6), "silu"),
    ((2, 40, 4, 3, 5), "silu"),
])
def test_group_norm_grad_matches_jax_vjp(shape, act):
    """K3's backward (plain fp32 recompute) against jax.grad through the JAX
    custom VJP `_group_norm_act`, dx, dγ and dβ."""
    import jax

    from hi3d_tpu.ops.group_norm import _group_norm_act

    rnd = np.random.RandomState(8)
    x = (rnd.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[1]
    w = rnd.randn(c).astype(np.float32)
    b = rnd.randn(c).astype(np.float32)
    cot = rnd.randn(*shape).astype(np.float32)
    groups = int(np.gcd(c, 32))

    def loss(x_, w_, b_):
        y = _group_norm_act(x_, w_, b_, groups, 1e-5, act)
        return jnp.vdot(y, jnp.asarray(np.moveaxis(cot, 1, -1)))

    rx, rw, rb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(w), jnp.asarray(b))
    gx, gw, gb = _torch_grads(lambda *t: gn.group_norm(*t, groups, 1e-5, act), (x, w, b), cot)
    np.testing.assert_allclose(gx, np.moveaxis(np.asarray(rx), -1, 1), atol=GRAD_ATOL, rtol=0)
    # dγ, dβ sum over N·spatial elements: fp32 sums of ~100 terms of O(1)
    np.testing.assert_allclose(gw, np.asarray(rw), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(gb, np.asarray(rb), atol=1e-3, rtol=1e-5)


def test_wrappers_raise_on_other_devices():
    """Only CPU tensors take the plain versions; anything else launches the
    kernel or raises — here a meta tensor, which no kernel takes."""
    q = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, q, q)
    with pytest.raises((ValueError, TypeError)):
        ta.temporal_attention(q[:, :, None], q[:, :, None], q[:, :, None])
    x = torch.empty((1, 32, 4, 4), device="meta")
    with pytest.raises((ValueError, TypeError)):
        gn.group_norm(x, x[0, :, 0, 0], x[0, :, 0, 0], 32)
    with pytest.raises((ValueError, TypeError)):
        gn.group_stats(x, 32, 1e-6)
    with pytest.raises((ValueError, TypeError)):
        ln.layer_norm(x, x[0, 0, 0], x[0, 0, 0])
    with pytest.raises((ValueError, TypeError)):
        ln.row_stats(x[0, 0], 1e-5)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 128, 1024, 1024), torch.float32),  # a 1024² VAE frame, chip_smoke's #9 case
    ((16, 256, 96, 96), torch.float32),  # a DPT backbone norm, chip_smoke's #9 case
    ((1, 128, 512, 512), torch.float32),  # the 512² VAE encoder's first norms
    ((1, 512, 64, 64), torch.float32),  # the VAE's mid-block at a 64² latent
    ((4, 512, 128, 128), torch.float32),  # the decoder at 4 frames
    ((16, 1024, 24, 24), torch.float32),  # the DPT's last stage
    ((2, 64, 33, 17), torch.bfloat16),  # a ragged group, bf16
    ((1, 96, 3, 5), torch.float16),  # a group of 15 elements
])
def test_group_stats_plan_covers_every_element(shape, dtype):
    """#9's planner: every element of every group in exactly one CTA slice
    (rank r owns [min(r·chunk, gs), min((r + 1)·chunk, gs)), as the kernel
    reads it), a cluster of 1–16 CTAs that divides the grid, slices of whole
    16-byte vectors, and about two CTAs an SM when a 1024² frame leaves only
    N·G = 32 groups."""
    n, c = shape[:2]
    groups, gs = n * 32, (c // 32) * int(np.prod(shape[2:]))
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    cluster, chunk = gn.plan_group_stats(groups, gs, vec)
    assert 1 <= cluster <= 16 and cluster & (cluster - 1) == 0
    assert (groups * cluster) % cluster == 0
    assert chunk % vec == 0 and chunk * cluster >= gs
    covered = np.zeros(gs, dtype=np.int64)
    for r in range(cluster):
        start = min(r * chunk, gs)
        end = min(start + chunk, gs)
        np.add.at(covered, np.arange(start, end), 1)
    assert (covered == 1).all()
    if groups == 32 and gs >= 1 << 20:
        assert groups * cluster >= 0.9 * gn.TARGET_CTAS
    if groups >= gn.TARGET_CTAS:
        assert cluster == 1


# bf16 inputs: both sides widen the same bf16 values to fp32 and sum in fp32
STATS_ATOL = 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", [(48, 320), (592, 768), (32, 1280)])
def test_row_stats_plain_matches_pallas(dtype, m, c):
    """#10's plain version against `pallas_row_stats` (interpret mode) at the
    UNet, DPT and CLIP widths; M is a multiple of the Pallas row chunk (16)
    but not of the kernel's row block."""
    from hi3d_tpu.ops.group_norm import pallas_row_stats

    rnd = np.random.RandomState(9)
    x = (rnd.randn(m, c) * 3 + 1.5).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    ref_mean, ref_inv = (np.asarray(a)[:, 0] for a in pallas_row_stats(jx, 1e-5))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    before = ln.row_stats.launches
    mean, inv = ln.row_stats(tx, 1e-5)
    assert ln.row_stats.launches == before  # CPU tensors never count a launch
    assert mean.dtype == inv.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), ref_mean, atol=STATS_ATOL, rtol=1e-6)
    np.testing.assert_allclose(inv.numpy(), ref_inv, atol=STATS_ATOL, rtol=1e-5)


@pytest.mark.parametrize("pallas", [False, True])
def test_layer_norm32_matches_jax(pallas, monkeypatch):
    """The port's LayerNorm32 (#10's plain version: one-pass moments, fp32
    apply) against JAX's LayerNorm32 on its default path (flax LayerNorm) and
    with HI3D_LN=pallas (`pallas_row_stats` + jnp apply), fp32 and bf16
    inputs, with the UNet's eps 1e-5 and the DPT's 1e-6.

    Tolerance: fp32 outputs of O(1) differ by summation order only (1e-5);
    bf16 outputs by at most one bf16 ulp where the fp32 results straddle a
    rounding boundary (3.2e-2 at |y| < 8)."""
    from hi3d_tpu.models.attention import LayerNorm32 as JaxLayerNorm32
    from hi3d_tpu_torch.models.attention import LayerNorm32

    if pallas:
        monkeypatch.setenv("HI3D_LN", "pallas")
    rnd = np.random.RandomState(10)
    x = (rnd.randn(2, 24, 64) * 2 + 0.7).astype(np.float32)
    w = (1 + 0.1 * rnd.randn(64)).astype(np.float32)
    b = (0.1 * rnd.randn(64)).astype(np.float32)
    params = {"params": {"norm": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}}
    for eps in (1e-5, 1e-6):
        tm = LayerNorm32(64, eps=eps)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(w))
            tm.bias.copy_(torch.from_numpy(b))
        for dtype, atol in (("float32", 1e-5), ("bfloat16", 3.2e-2)):
            jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
            ref = np.asarray(JaxLayerNorm32(epsilon=eps).apply(params, jx).astype(jnp.float32))
            tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
            with torch.no_grad():
                out = tm(tx)
            assert out.dtype == tx.dtype
            np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=0)


def test_layer_norm_grad_matches_pallas_vjp():
    """`layer_norm`'s backward (plain fp32, from the saved mean and inv_std)
    against jax.grad through `pallas_row_stats`'s custom VJP and the jnp
    apply, as JAX's LayerNorm32 runs under HI3D_LN=pallas: dx, dγ, dβ."""
    import jax

    from hi3d_tpu.ops.group_norm import pallas_row_stats

    rnd = np.random.RandomState(11)
    m, c = 64, 96
    x = (rnd.randn(m, c) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rnd.randn(c)).astype(np.float32)
    b = (0.1 * rnd.randn(c)).astype(np.float32)
    cot = rnd.randn(m, c).astype(np.float32)

    def loss(x_, w_, b_):
        mean, inv = pallas_row_stats(x_, 1e-5)
        return jnp.vdot((x_ - mean) * inv * w_ + b_, jnp.asarray(cot))

    rx, rw, rb = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, w, b)))
    gx, gw, gb = _torch_grads(lambda *t: ln.layer_norm(*t, 1e-5), (x, w, b), cot)
    np.testing.assert_allclose(gx, np.asarray(rx), atol=GRAD_ATOL, rtol=0)
    # dγ, dβ sum over 64 rows of O(1) terms
    np.testing.assert_allclose(gw, np.asarray(rw), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(gb, np.asarray(rb), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("shape,groups", [
    ((2, 128, 16, 16), 32),   # a VAE norm (C 128, 32 groups)
    ((3, 64, 12, 8), 32),     # a DPT stem norm
    ((1, 40, 4, 4), 8),
])
def test_group_stats_plain_matches_pallas(shape, groups):
    """#9's plain version against `pallas_group_stats` (interpret mode) on
    the channels-last transpose of the same tensor."""
    from hi3d_tpu.ops.group_norm import pallas_group_stats

    rnd = np.random.RandomState(12)
    x = (rnd.randn(*shape) * 2 + 0.5).astype(np.float32)
    ref_mean, ref_inv = (np.asarray(a) for a in
                         pallas_group_stats(jnp.asarray(np.moveaxis(x, 1, -1)), groups, 1e-6))
    before = gn.group_stats.launches
    mean, inv = gn.group_stats(torch.from_numpy(x), groups, 1e-6)
    assert gn.group_stats.launches == before
    assert tuple(mean.shape) == (shape[0], groups)
    np.testing.assert_allclose(mean.numpy(), ref_mean, atol=STATS_ATOL, rtol=1e-6)
    np.testing.assert_allclose(inv.numpy(), ref_inv, atol=STATS_ATOL, rtol=1e-5)


# ------------------------------------------------------------------ image IO


def _png_with_filter(img: np.ndarray, ftype: int) -> bytes:
    """Encode uint8 (H, W, C) with one PNG scanline filter on every row."""
    h, w, ch = img.shape
    bpp, stride = ch, w * ch
    rows = img.reshape(h, stride).astype(np.int64)
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out.extend(((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ctype = {3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [3, 4])
def test_png_reader_all_filters_match_cv2(tmp_path, ftype, channels):
    import cv2

    from hi3d_tpu_torch.utils.png import read_png

    img = (np.random.RandomState(ftype).rand(9, 13, channels) * 255).astype(np.uint8)
    path = tmp_path / f"f{ftype}.png"
    path.write_bytes(_png_with_filter(img, ftype))
    got = read_png(str(path))
    np.testing.assert_array_equal(got, img)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, ref[..., [2, 1, 0, 3][:channels]])


def test_demo_image_and_resize_match_cv2(tmp_path):
    import cv2

    from hi3d_tpu.utils.image import resize_center_crop as jax_resize_center_crop
    from hi3d_tpu_torch.utils.image import load_image_rgb, resize_bilinear_u8, resize_center_crop
    from hi3d_tpu_torch.utils.png import read_png, write_png

    img = load_image_rgb("demo/3.png")
    np.testing.assert_array_equal(img, cv2.imread("demo/3.png")[..., ::-1])
    # identity at the demo's own size
    np.testing.assert_array_equal(resize_center_crop(img, (512, 512)), img)
    for size in ((64, 64), (300, 200), (700, 700)):
        got = resize_center_crop(img, size)
        ref = jax_resize_center_crop(img, size)
        assert got.shape == ref.shape
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    small = (np.random.RandomState(0).rand(37, 50, 3) * 255).astype(np.uint8)
    diff = resize_bilinear_u8(small, (71, 23)).astype(int) - cv2.resize(small, (71, 23)).astype(int)
    assert np.abs(diff).max() <= 1
    write_png(str(tmp_path / "w.png"), small)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), small)
