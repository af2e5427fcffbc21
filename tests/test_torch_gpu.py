"""The port's CUDA kernels on the card, against their plain
PyTorch versions on the same inputs; forward and backward, and the autograd
wiring (every kernel output carries a grad_fn, gradients reach every input).

This file imports neither jax nor hi3d_tpu, so it runs on a torch-only GPU
host. There, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite). Every
test takes the `cuda` fixture and skips without a card.

Tolerances: bf16 inputs, fp32 accumulation on both sides; outputs are O(1)
(2e-2 absolute ≈ a few bf16 ulps; 6e-2 for GroupNorm and LayerNorm outputs
up to ~8) and gradients are compared relative to their largest entry
(2e-2). Norm statistics are fp32 on both sides and differ in summation order
only (1e-4 relative).
"""

import pytest
import torch

from hi3d_tpu_torch.ops import flash_attention as fa
from hi3d_tpu_torch.ops import group_norm as gn
from hi3d_tpu_torch.ops import layer_norm as ln
from hi3d_tpu_torch.ops import temporal_attention as ta


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_flash_attention_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 200, 3 * 5 * 64), generator=g, device=cuda, dtype=torch.bfloat16)
    q, k, v = (x[..., i * 320:(i + 1) * 320].view(2, 200, 5, 64) for i in range(3))
    out, lse = fa.flash_attention(q, k, v)
    ref, ref_lse = fa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 2, 5, 16, 17, 32])
@pytest.mark.parametrize("d", [64, 128])
def test_temporal_attention_kernel_matches_plain(cuda, t, d):
    """K2 at every T that changes its tiling (one or two 16-row query tiles,
    padded keys) and both head dims, on S = 67 locations (the groups of
    adjacent segments do not divide B·S·H); a second call is bitwise the
    same."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, t, 67, 2 * d), generator=g, device=cuda,
                           dtype=torch.bfloat16).view(2, t, 67, 2, d) for _ in range(3))
    out = ta.temporal_attention(q, k, v)
    ref = ta.temporal_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    assert torch.equal(ta.temporal_attention(q, k, v), out)


@pytest.mark.gpu
def test_temporal_attention_kernel_at_the_unet_sites(cuda):
    """K2 at the stage-1 UNet's 64² site and stage 2's 128² site (B2 T16
    S16384 C320), and on q, k, v sliced from one packed qkv projection; a
    base or stride off 16 bytes raises instead."""
    g = torch.Generator(device=cuda).manual_seed(9)
    for s in (4096, 16384):
        q, k, v = (torch.randn((2, 16, s, 320), generator=g, device=cuda,
                               dtype=torch.bfloat16).view(2, 16, s, 5, 64) for _ in range(3))
        out = ta.temporal_attention(q, k, v)
        ref = ta.temporal_attention_reference(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() < 2e-2
    x = torch.randn((2, 16, 100, 3 * 320 + 8), generator=g, device=cuda, dtype=torch.bfloat16)
    q, k, v = (x[..., i * 320:(i + 1) * 320].unflatten(-1, (5, 64)) for i in range(3))
    out = ta.temporal_attention(q, k, v)
    ref = ta.temporal_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    with pytest.raises(ValueError):
        ta.temporal_attention(*(x[..., 2 + i * 320:2 + (i + 1) * 320].unflatten(-1, (5, 64))
                                for i in range(3)))


def _group_norm_inputs(g, cuda):
    """(x, act): small shapes, the UNet's 2-D norm at 64² with and without
    SiLU, a 32² time stack, the serve time stack as the (B, C, T, H, W) view
    of a (B, T, C, H, W) tensor (groups larger than a cluster keeps: the
    streamed path), a stage-2 2-D norm at 128²; and layouts read by single
    elements: 5² rows, a channels-last view, a start off 16 bytes; fp32."""
    bf16 = torch.bfloat16

    def rnd(shape, dtype=bf16):
        return (torch.randn(shape, generator=g, device=cuda) * 3 + 1).to(dtype)

    return ((rnd((4, 320, 16, 16)), "silu"), (rnd((2, 640, 4, 8, 8)), "silu"),
            (rnd((32, 320, 64, 64)), None), (rnd((32, 320, 64, 64)), "silu"),
            (rnd((2, 640, 16, 32, 32)), "silu"),
            (rnd((4, 48, 320, 64, 64)).permute(0, 2, 1, 3, 4), "silu"),
            (rnd((32, 320, 128, 128)), "silu"),
            (rnd((4, 64, 5, 5)), "silu"), (rnd((2, 8, 8, 64)).permute(0, 3, 1, 2), None),
            (rnd((2 * 64 * 64 + 1,))[1:].view(2, 64, 8, 8), None),
            (rnd((4, 64, 16, 16), torch.float32), None))


@pytest.mark.gpu
def test_group_norm_kernel_matches_plain(cuda):
    """K3 against its plain version at `_group_norm_inputs`: y contiguous in
    x's dtype within 6e-2 (bf16: γ = 1 + 0.1·randn and β = 0.1·randn keep
    |y| < 8, where a rounding flip is one ulp of at most 3.1e-2; fp32 1e-4),
    and a second call gives bitwise the same y."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for x, act in _group_norm_inputs(g, cuda):
        w = 1 + 0.1 * torch.randn((x.shape[1],), generator=g, device=cuda)
        b = 0.1 * torch.randn((x.shape[1],), generator=g, device=cuda)
        out = gn.group_norm(x, w, b, 32, 1e-5, act)
        ref = gn.group_norm_reference(x, w, b, 32, 1e-5, act)
        assert out.is_contiguous() and out.dtype == x.dtype
        tol = 1e-4 if x.dtype == torch.float32 else 6e-2
        assert (out.float() - ref.float()).abs().max().item() < tol, tuple(x.shape)
        assert torch.equal(gn.group_norm(x, w, b, 32, 1e-5, act), out), tuple(x.shape)


@pytest.mark.gpu
def test_kernels_at_the_single_pass_half_batch(cuda):
    """The single-pass steps of --cfg_interval hand the stage-1 UNet one
    video instead of a CFG-doubled pair: K2 at B1 T16 at its four sites (64²
    to 8²), K3 at (16, 320, 64, 64) and at the time-stack view (1, 320, 16,
    64, 64), +SiLU; the tolerances above, a second call bitwise the same."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for s, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        q, k, v = (torch.randn((1, 16, s, c), generator=g, device=cuda,
                               dtype=torch.bfloat16).view(1, 16, s, c // 64, 64) for _ in range(3))
        out = ta.temporal_attention(q, k, v)
        ref = ta.temporal_attention_reference(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() < 2e-2, (s, c)
        assert torch.equal(ta.temporal_attention(q, k, v), out)
    for x in (torch.randn((16, 320, 64, 64), generator=g, device=cuda),
              torch.randn((1, 16, 320, 64, 64), generator=g, device=cuda).permute(0, 2, 1, 3, 4)):
        x = (x * 3 + 1).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn((320,), generator=g, device=cuda)
        b = 0.1 * torch.randn((320,), generator=g, device=cuda)
        out = gn.group_norm(x, w, b, 32, 1e-5, "silu")
        ref = gn.group_norm_reference(x, w, b, 32, 1e-5, "silu")
        assert out.is_contiguous() and out.dtype == x.dtype
        assert (out.float() - ref.float()).abs().max().item() < 6e-2, tuple(x.shape)
        assert torch.equal(gn.group_norm(x, w, b, 32, 1e-5, "silu"), out)


@pytest.mark.gpu
def test_kernel_outputs_carry_grad_fn(cuda):
    """On the card each kernel's output is part of the autograd graph when its
    inputs need gradients, and gradients reach every input (γ and β too)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 128, 2, 64), generator=g, device=cuda, dtype=torch.bfloat16)
               .requires_grad_() for _ in range(3))
    out, _ = fa.flash_attention(q, k, v)
    t5 = [torch.randn((2, 16, 8, 2, 64), generator=g, device=cuda, dtype=torch.bfloat16)
          .requires_grad_() for _ in range(3)]
    tout = ta.temporal_attention(*t5)
    x = torch.randn((2, 64, 8, 8), generator=g, device=cuda, dtype=torch.bfloat16).requires_grad_()
    w = torch.ones(64, device=cuda, requires_grad=True)
    bias = torch.zeros(64, device=cuda, requires_grad=True)
    y = gn.group_norm(x, w, bias, 32, 1e-5, "silu")
    for o in (out, tout, y):
        assert o.grad_fn is not None
    (out.float().sum() + tout.float().sum() + y.float().square().sum()).backward()
    for t in (q, k, v, *t5, x, w, bias):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.gpu
def test_flash_attention_backward_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    for s in (200, 1024):
        x = torch.randn((2, s, 3 * 5 * 64), generator=g, device=cuda, dtype=torch.bfloat16)
        q, k, v = (x[..., i * 320:(i + 1) * 320].view(2, s, 5, 64) for i in range(3))
        dout = torch.randn((2, s, 5, 64), generator=g, device=cuda, dtype=torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v)
        got = fa.flash_attention_backward(q, k, v, out, lse, dout)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(fa.flash_attention_reference(*leaves)[0], leaves, dout)
        for a, b in zip(got, want):
            assert _rel_err(a, b) < 2e-2


# K1 and #3 at the lengths the 128-row blocks and 64/128-row tiles make
# delicate (1, one short of a tile, a tile, one past it, ...), equal and
# unequal query and key lengths, and every head dim the kernels take; q, k, v
# are head-strided views of one (B, S, 3·H·D) projection (sliced to their
# lengths), as the UNet hands them over.
FLASH_LENGTHS = [(s, s) for s in (1, 63, 64, 65, 127, 129, 200)] + [
    (65, 200), (200, 63), (1, 129), (129, 1)]


def _flash_inputs(g, cuda, sq, sk, d, h=3, b=2):
    x = torch.randn((b, max(sq, sk), 3 * h * d), generator=g, device=cuda, dtype=torch.bfloat16)
    q = x[:, :sq, :h * d].view(b, sq, h, d)
    k = x[:, :sk, h * d:2 * h * d].view(b, sk, h, d)
    v = x[:, :sk, 2 * h * d:].view(b, sk, h, d)
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("sq,sk", FLASH_LENGTHS)
def test_flash_attention_kernel_ragged_lengths(cuda, sq, sk, d):
    g = torch.Generator(device=cuda).manual_seed(sq * 1000 + sk + d)
    q, k, v = _flash_inputs(g, cuda, sq, sk, d)
    out, lse = fa.flash_attention(q, k, v)
    ref, ref_lse = fa.flash_attention_reference(q, k, v)
    assert out.shape == q.shape and lse.shape == (2, 3, sq)
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("sq,sk", FLASH_LENGTHS)
def test_flash_attention_backward_ragged_lengths(cuda, sq, sk, d):
    """Within 2e-2 of each gradient's largest entry; at a single key the
    softmax is constant and dq, dk vanish, so the scale has a floor of 1e-3."""
    g = torch.Generator(device=cuda).manual_seed(sq * 1000 + sk + d + 1)
    q, k, v = _flash_inputs(g, cuda, sq, sk, d)
    dout = torch.randn(q.shape, generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = fa.flash_attention(q, k, v)
    got = fa.flash_attention_backward(q, k, v, out, lse, dout)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_reference(*leaves)[0], leaves, dout)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = max(b.float().abs().max().item(), 1e-3)
        assert (a.float() - b.float()).abs().max().item() < 2e-2 * scale


@pytest.mark.gpu
def test_flash_attention_backward_is_deterministic(cuda):
    """No atomics: two runs of #3 on the same inputs agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = _flash_inputs(g, cuda, 1000, 1000, 64, h=5)
    dout = torch.randn(q.shape, generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = fa.flash_attention(q, k, v)
    first = fa.flash_attention_backward(q, k, v, out, lse, dout)
    second = fa.flash_attention_backward(q, k, v, out, lse, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _frame_grads_match(got, want):
    """#5's gradients against the plain ones, each within 2e-2 of its
    largest entry; a gradient that is 0 exactly (dq, dk at T = 1, where the
    one probability is 1) must be 0 exactly."""
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        if b.abs().max().item() == 0:
            assert not a.any()
        else:
            assert _rel_err(a, b) < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 2, 5, 16, 17, 32])
@pytest.mark.parametrize("d", [64, 128])
def test_temporal_attention_backward_kernel_matches_plain(cuda, t, d):
    """#5 fed K2's O, against autograd through the plain forward, at every T
    that changes its tiling (one or two 16-frame tiles, padded frames) and
    both head dims, on S = 67 locations (the last group of adjacent segments
    is not full)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, dout = (torch.randn((2, t, 67, 2 * d), generator=g, device=cuda,
                                 dtype=torch.bfloat16).view(2, t, 67, 2, d) for _ in range(4))
    out = ta.temporal_attention(q, k, v)
    got = ta.temporal_attention_backward(q, k, v, out, dout)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ta.temporal_attention_reference(*leaves), leaves, dout)
    _frame_grads_match(got, want)


@pytest.mark.gpu
def test_temporal_attention_backward_is_deterministic(cuda):
    """No atomics: two runs of #5 on the same inputs agree bit for bit, with
    one 16-frame tile (T = 16) and two (T = 32)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    for t in (16, 32):
        q, k, v, dout = (torch.randn((2, t, 256, 320), generator=g, device=cuda,
                                     dtype=torch.bfloat16).view(2, t, 256, 5, 64)
                         for _ in range(4))
        out = ta.temporal_attention(q, k, v)
        first = ta.temporal_attention_backward(q, k, v, out, dout)
        second = ta.temporal_attention_backward(q, k, v, out, dout)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_temporal_attention_backward_copies_operands_off_the_rule(cuda):
    """#5's public call takes a q 2 elements off the 8-element rule and a
    transposed dO 2 elements off it: the wrapper copies them (16-byte
    copies need the rule) and the gradients match the plain ones."""
    g = torch.Generator(device=cuda).manual_seed(15)
    b, t, s, h, d = 2, 16, 67, 5, 64
    bf16 = torch.bfloat16
    q = torch.randn((b, t, s, h * d + 2), generator=g, device=cuda, dtype=bf16)[..., 2:]
    dout = torch.randn((b, s, t, h * d + 2), generator=g, device=cuda,
                       dtype=bf16)[..., 2:].transpose(1, 2)
    q, dout = q.unflatten(-1, (h, d)), dout.unflatten(-1, (h, d))
    k, v = (torch.randn((b, t, s, h, d), generator=g, device=cuda, dtype=bf16)
            for _ in range(2))
    assert not ta._packed(q) and not ta._packed(dout) and not dout.is_contiguous()
    out = ta.temporal_attention(q.contiguous(), k, v)
    got = ta.temporal_attention_backward(q, k, v, out, dout)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ta.temporal_attention_reference(*leaves), leaves, dout)
    _frame_grads_match(got, want)


@pytest.mark.gpu
def test_group_norm_backward_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    for shape in ((4, 320, 16, 16), (2, 640, 4, 8, 8)):
        x = torch.randn(shape, generator=g, device=cuda, dtype=torch.bfloat16)
        w = torch.randn((shape[1],), generator=g, device=cuda)
        bias = torch.randn((shape[1],), generator=g, device=cuda)
        dy = torch.randn(shape, generator=g, device=cuda, dtype=torch.bfloat16)
        leaves = [t.detach().requires_grad_() for t in (x, w, bias)]
        got = torch.autograd.grad(gn.group_norm(*leaves, 32, 1e-5, "silu"), leaves, dy)
        leaves = [t.detach().requires_grad_() for t in (x, w, bias)]
        want = torch.autograd.grad(gn.group_norm_reference(*leaves, 32, 1e-5, "silu"), leaves, dy)
        for a, b in zip(got, want):
            assert _rel_err(a, b) < 2e-2


def _close_rel(a, b, tol=1e-4):
    return ((a - b).abs().max() / b.abs().max()).item() < tol


def _layer_norm_cases(g, cuda):
    """(x, γ/β dtype, eps): a UNet width (bf16), the DPT's (fp32), CLIP's
    (bf16, rows read through a strided view as `ln_post(x[:, 0])` does); γ
    and β in bf16; C = 333 (not a multiple of a vector); a misaligned view
    (`x[:, 1:]` of a wider tensor); C = 4096 and 8192 (a block a row); M = 1.
    Up to a few thousand rows take a block a row; the cases of 8192 rows and
    more take 8, 16 and 32 lanes a row, aligned and not."""
    bf16 = torch.bfloat16

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=cuda, dtype=dtype)

    return ((rnd((4, 1000, 320), bf16), torch.float32, 1e-5),
            (rnd((3, 577, 768)), torch.float32, 1e-6),
            (rnd((3, 257, 1280), bf16)[:, 0], torch.float32, 1e-5),
            (rnd((2, 100, 640), bf16), bf16, 1e-5),
            (rnd((3, 77, 1024)), bf16, 1e-5),
            (rnd((50, 333)), torch.float32, 1e-5),
            (rnd((50, 333), bf16), bf16, 1e-5),
            (rnd((64, 769))[:, 1:], torch.float32, 1e-5),
            (rnd((64, 1281), bf16)[:, 1:], torch.float32, 1e-5),
            (rnd((40, 4096), bf16), torch.float32, 1e-5),
            (rnd((20, 8192)), torch.float32, 1e-5),
            (rnd((7, 8192), torch.float16), torch.float16, 1e-5),
            (rnd((1, 1280), bf16), torch.float32, 1e-5),
            (rnd((1, 5000)), torch.float32, 1e-5),
            (rnd((32, 1024, 320), bf16), torch.float32, 1e-5),
            (rnd((16 * 577, 768)), bf16, 1e-6),
            (rnd((8192, 333), bf16), torch.float32, 1e-5),
            (rnd((8192, 769))[:, 1:], torch.float32, 1e-5),
            (rnd((8192, 1281), bf16)[:, 1:], bf16, 1e-5))


@pytest.mark.gpu
def test_layer_norm_kernel_matches_plain(cuda):
    """#10 against its plain version at the cases of `_layer_norm_cases`:
    y in x's dtype, (mean, inv_std) through `row_stats`; and a second call
    gives bitwise the same results."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for x, wdtype, eps in _layer_norm_cases(g, cuda):
        x = x * 2 + 0.5 if x.is_contiguous() else x.mul_(2).add_(0.5)
        c = x.shape[-1]
        # |y| < 8, so that a bf16 rounding flip (the fp32 sums differ in
        # order) is at most one ulp of 3.1e-2
        w = (1 + 0.1 * torch.randn((c,), generator=g, device=cuda)).to(wdtype)
        b = (0.1 * torch.randn((c,), generator=g, device=cuda)).to(wdtype)
        out = ln.layer_norm(x, w, b, eps)
        ref = ln.layer_norm_reference(x, w, b, eps)
        assert out.dtype == x.dtype and out.shape == x.shape
        tol = 1e-4 if x.dtype == torch.float32 else 6e-2
        assert (out.float() - ref.float()).abs().max().item() < tol, (tuple(x.shape), x.dtype)
        assert torch.equal(ln.layer_norm(x, w, b, eps), out)
        x2d = x.reshape(-1, c)
        mean, inv = ln.row_stats(x2d, eps)
        ref_mean, ref_inv = ln.row_stats_reference(x2d, eps)
        assert _close_rel(mean, ref_mean) and _close_rel(inv, ref_inv), tuple(x.shape)
        again = ln.row_stats(x2d, eps)
        assert torch.equal(again[0], mean) and torch.equal(again[1], inv)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [768, 320])
def test_layer_norm_reads_strided_gamma_beta(cuda, c):
    """#10 with γ and β as strided views (every second element): the
    wrapper's contiguous copies stay alive until the launch has returned,
    so the kernel reads them and not freed memory. With a gradient the
    wrapper also allocates (mean, inv_std) after the copies, at 300 rows in
    a block small enough to take a freed copy's place."""
    g = torch.Generator(device=cuda).manual_seed(10)
    for dtype in (torch.float32, torch.bfloat16):
        for rows, grad in ((300, True), (300, False), (4 * 577, False)):
            x = (torch.randn((rows, c), generator=g, device=cuda) * 3 + 1).to(dtype)
            w = (1 + 0.1 * torch.randn((2 * c,), generator=g, device=cuda))[::2]
            b = (0.1 * torch.randn((2 * c,), generator=g, device=cuda))[::2]
            assert not w.is_contiguous()
            out = ln.layer_norm(x.requires_grad_(grad), w, b, 1e-6)
            ref = ln.layer_norm_reference(x.detach(), w, b, 1e-6)
            tol = 1e-4 if dtype == torch.float32 else 6e-2
            assert (out.float() - ref.float()).abs().max().item() < tol, (dtype, rows, grad)


@pytest.mark.gpu
def test_group_stats_kernel_matches_plain(cuda):
    """#9 at a 256² VAE norm (4 groups of 2 M elements a cluster), a DPT norm
    and a ragged shape, bf16 input, a group of 15 elements (not a multiple
    of 4) and at a misaligned start, a 1024² frame (clusters of 8) and 512
    groups (a CTA a group); a second call gives bitwise the same results;
    and the FoldedGroupNorm module on it against torch's GroupNorm."""
    from hi3d_tpu_torch.models.layers import FoldedGroupNorm

    g = torch.Generator(device=cuda).manual_seed(6)
    for shape, dtype in (((1, 128, 256, 256), torch.float32), ((4, 256, 24, 24), torch.float32),
                         ((2, 64, 33, 17), torch.float32), ((2, 64, 33, 17), torch.bfloat16),
                         ((3, 96, 3, 5), torch.float32), ((1, 128, 1024, 1024), torch.float32),
                         ((16, 256, 96, 96), torch.float32)):
        x = (torch.randn(shape, generator=g, device=cuda) * 3 + 1).to(dtype)
        mean, inv = gn.group_stats(x, 32, 1e-6)
        ref_mean, ref_inv = gn.group_stats_reference(x, 32, 1e-6)
        assert mean.shape == (shape[0], 32)
        assert _close_rel(mean, ref_mean) and _close_rel(inv, ref_inv), (shape, dtype)
        again = gn.group_stats(x, 32, 1e-6)
        assert torch.equal(again[0], mean) and torch.equal(again[1], inv)
        if dtype != torch.float32 or x.numel() > 1 << 24:
            continue
        norm = FoldedGroupNorm(32, shape[1], eps=1e-6).to(cuda)
        with torch.no_grad():
            norm.weight.normal_(generator=g)
            norm.bias.normal_(generator=g)
            out = norm(x)
            ref = torch.nn.functional.group_norm(x, 32, norm.weight, norm.bias, 1e-6)
        assert (out - ref).abs().max().item() < 1e-3
    # a group that starts off a 16-byte boundary: 15-element groups after one element
    x = torch.randn((2 * 96 * 15 + 1,), generator=g, device=cuda)[1:].view(2, 96, 3, 5)
    mean, inv = gn.group_stats(x, 32, 1e-6)
    ref_mean, ref_inv = gn.group_stats_reference(x, 32, 1e-6)
    assert _close_rel(mean, ref_mean) and _close_rel(inv, ref_inv)


@pytest.mark.gpu
def test_norm_calls_launch_one_kernel(cuda):
    """By the profiler, one `ln.layer_norm`, `ln.row_stats`,
    `gn.group_stats` or `gn.group_norm` call runs exactly one device kernel:
    no cast, copy, fill or fold beside it, with γ and β in bf16 too, and K3
    on the time stack's permuted view through `GroupNorm32`."""
    from hi3d_tpu_torch.models.layers import GroupNorm32

    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((16 * 577, 768), generator=g, device=cuda)
    w, b = (torch.randn((768,), generator=g, device=cuda) for _ in range(2))
    xb = torch.randn((4096, 320), generator=g, device=cuda, dtype=torch.bfloat16)
    wb, bb = (torch.randn((320,), generator=g, device=cuda, dtype=torch.bfloat16)
              for _ in range(2))
    xg = torch.randn((1, 128, 1024, 1024), generator=g, device=cuda)
    x3 = torch.randn((32, 320, 64, 64), generator=g, device=cuda, dtype=torch.bfloat16)
    w3, b3 = (torch.randn((320,), generator=g, device=cuda) for _ in range(2))
    w3b, b3b = w3.bfloat16(), b3.bfloat16()
    x5 = torch.randn((2, 16, 320, 64, 64), generator=g, device=cuda,
                     dtype=torch.bfloat16).permute(0, 2, 1, 3, 4)
    norm = GroupNorm32(320, act="silu").to(cuda, torch.bfloat16)
    calls = (lambda: ln.layer_norm(x, w, b, 1e-6), lambda: ln.layer_norm(xb, wb, bb, 1e-5),
             lambda: ln.row_stats(x, 1e-6), lambda: gn.group_stats(xg, 32, 1e-6),
             lambda: gn.group_stats(xg.view(16, 256, 128, 256), 32, 1e-6),
             lambda: gn.group_norm(x3, w3, b3, 32, 1e-5, "silu"),
             lambda: gn.group_norm(x3, w3b, b3b, 32, 1e-5),
             lambda: norm(x5))
    for call in calls:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        assert len(kernels) == 1, kernels


@pytest.mark.gpu
def test_norm_outputs_carry_grad_fn(cuda):
    """#10 through LayerNorm32 and #9 through FoldedGroupNorm on the card:
    the outputs carry a grad_fn and the gradients match autograd of the
    plain versions."""
    from hi3d_tpu_torch.models.attention import LayerNorm32
    from hi3d_tpu_torch.models.layers import FoldedGroupNorm

    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((2, 256, 320), generator=g, device=cuda, dtype=torch.bfloat16)
    dy = torch.randn(x.shape, generator=g, device=cuda, dtype=torch.bfloat16)
    norm = LayerNorm32(320).to(cuda)
    xg = x.detach().requires_grad_()
    y = norm(xg)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, [xg, norm.weight, norm.bias], dy)
    leaves = [t.detach().requires_grad_() for t in (x, norm.weight, norm.bias)]
    want = torch.autograd.grad(ln.layer_norm_reference(*leaves, 1e-5), leaves, dy)
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 2e-2

    x = torch.randn((2, 64, 16, 16), generator=g, device=cuda)
    dy = torch.randn(x.shape, generator=g, device=cuda)
    gnorm = FoldedGroupNorm(32, 64, eps=1e-6).to(cuda)
    xg = x.detach().requires_grad_()
    y = gnorm(xg)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, [xg, gnorm.weight, gnorm.bias], dy)
    leaves = [t.detach().requires_grad_() for t in (x, gnorm.weight, gnorm.bias)]
    want = torch.autograd.grad(gn.group_norm_reference(*leaves, 32, 1e-6), leaves, dy)
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 2e-2


def _segments(g, cuda, b, t, s, h, d, n=3):
    """n (B, S, T, H, D) views of (B, T, S, H·D) projections, as the UNet
    hands them to #6."""
    return [torch.randn((b, t, s, h * d), generator=g, device=cuda, dtype=torch.bfloat16)
            .view(b, t, s, h, d).transpose(1, 2) for _ in range(n)]


@pytest.mark.gpu
def test_block_attention_kernel_matches_plain(cuda):
    """#6 at ragged and padded segment lengths and both head dims, on
    transposed views (no copy in) and on a contiguous (B, S·T, H, D) input."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for t, d in ((33, 64), (48, 64), (64, 128), (48, 128)):
        q, k, v = _segments(g, cuda, 2, t, 24, 2, d)
        out = ta.segment_attention(q, k, v)
        ref, ref_lse = ta.temporal_block_attention_reference(q, k, v)
        _, lse = ta._block_forward(q, k, v, None)
        assert out.stride() == q.stride()  # written in the callers' (B, T, S, H, D) order
        assert (out.float() - ref.float()).abs().max().item() < 2e-2
        assert (lse - ref_lse).abs().max().item() < 1e-3
    x = [torch.randn((2, 8 * 40, 3, 64), generator=g, device=cuda, dtype=torch.bfloat16)
         for _ in range(3)]
    out = ta.temporal_block_attention(*x, 40)
    ref, _ = ta.temporal_block_attention_reference(*(y.unflatten(1, (8, 40)) for y in x))
    assert (out.float() - ref.flatten(1, 2).float()).abs().max().item() < 2e-2


@pytest.mark.gpu
def test_block_attention_backward_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    for t, d in ((33, 64), (48, 64), (64, 128)):
        q, k, v, dout = _segments(g, cuda, 2, t, 24, 2, d, n=4)
        out, lse = ta._block_forward(q, k, v, None)
        got = ta.temporal_block_attention_backward(q, k, v, out, lse, dout)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(ta.temporal_block_attention_reference(*leaves)[0], leaves, dout)
        for a, b in zip(got, want):
            assert _rel_err(a, b) < 2e-2


# #6 and #7 at segment lengths around their 16-row tiles, #6's 64-frame key
# blocks and 8-tile query chunks, and #7's 64-frame blocks (one block up to
# T = 64, then several, past the 256 frames an older #7 took)
SEGMENT_LENGTHS = [2, 17, 33, 48, 64, 129, 136, 256, 257, 300, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", SEGMENT_LENGTHS)
def test_block_attention_any_length_matches_plain(cuda, t, d):
    """#6 (O and lse) and #7 against their plain versions on transposed
    views, 5 segments a (b, s) so groups of segments end mid-location."""
    g = torch.Generator(device=cuda).manual_seed(100 + t + d)
    q, k, v, dout = _segments(g, cuda, 2, t, 3, 5, d, n=4)
    out, lse = ta._block_forward(q, k, v, None)
    ref, ref_lse = ta.temporal_block_attention_reference(q, k, v)
    assert out.stride() == q.stride() and torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err < 2e-2 and err < 2e-2 * ref.float().abs().max().item()
    assert (lse - ref_lse).abs().max().item() < 1e-3
    got = ta.temporal_block_attention_backward(q, k, v, out, lse, dout)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ta.temporal_block_attention_reference(*leaves)[0], leaves, dout)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and _rel_err(a, b) < 2e-2


@pytest.mark.gpu
def test_block_attention_backward_is_deterministic(cuda):
    """No atomics: two runs of #7 on the same inputs agree bit for bit, with
    one frame block (T = 48) and several (T = 256, 512)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    for t, d in ((48, 64), (256, 128), (512, 64)):
        q, k, v, dout = _segments(g, cuda, 2, t, 8, 2, d, n=4)
        out, lse = ta._block_forward(q, k, v, None)
        first = ta.temporal_block_attention_backward(q, k, v, out, lse, dout)
        second = ta.temporal_block_attention_backward(q, k, v, out, lse, dout)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_block_attention_carries_grad_fn_and_limits(cuda):
    """#6's output is in the autograd graph and its gradients reach q, k, v
    through #7; #6 and #7 run a 300-frame segment (no segment limit)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (x.detach().requires_grad_() for x in _segments(g, cuda, 2, 40, 16, 2, 64))
    before = ta.temporal_block_attention_backward.launches
    out = ta.segment_attention(q, k, v)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    assert ta.temporal_block_attention_backward.launches == before + 1
    for x in (q, k, v):
        assert x.grad is not None and torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    seg300 = _segments(g, cuda, 1, 300, 8, 1, 64, n=4)
    out, lse = ta._block_forward(*seg300[:3], None)
    ref, _ = ta.temporal_block_attention_reference(*seg300[:3])
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    got = ta.temporal_block_attention_backward(*seg300[:3], out, lse, seg300[3])
    leaves = [x.detach().requires_grad_() for x in seg300[:3]]
    want = torch.autograd.grad(ta.temporal_block_attention_reference(*leaves)[0], leaves,
                               seg300[3])
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and _rel_err(a, b) < 2e-2
    with pytest.raises(ValueError, match="below 2"):
        ta.temporal_block_attention_backward(*(x[:, :, :1] for x in seg300[:3]), out[:, :, :1],
                                             lse[..., :1], seg300[3][:, :, :1])


@pytest.mark.gpu
def test_time_self_attention_routes_long_clips_to_block_kernel(cuda):
    """T = 33 and T = 48 go through #6 and not K2; T = 32 stays on K2."""
    from hi3d_tpu_torch.ops import attention as attn_ops

    g = torch.Generator(device=cuda).manual_seed(11)
    for t, kernel in ((33, "block"), (48, "block"), (32, "k2")):
        q, k, v = (torch.randn((2, t, 64, 320), generator=g, device=cuda, dtype=torch.bfloat16)
                   .view(2, t, 64, 5, 64) for _ in range(3))
        k2, blk = ta.temporal_attention.launches, ta.temporal_block_attention.launches
        out = attn_ops.time_self_attention(q, k, v)
        assert (ta.temporal_attention.launches - k2, ta.temporal_block_attention.launches - blk) \
            == ((0, 1) if kernel == "block" else (1, 0))
        assert out.shape == q.shape
        ref = ta.temporal_attention_reference(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("t", [16, 48])
def test_time_self_attention_raises_on_fp32_at_kernel_head_dims(cuda, t):
    """An fp32 frame-axis call at head dim 64 reaches its kernel's wrapper
    (K2 at 16 frames, #6 at 48), which refuses the dtype: no plain path
    hides the kernel. Past head dim 256 the same call is plain and launches
    nothing."""
    from hi3d_tpu_torch.ops import attention as attn_ops

    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn((1, t, 8, 64), generator=g, device=cuda).view(1, t, 8, 1, 64)
               for _ in range(3))
    with pytest.raises(TypeError, match="bfloat16"):
        attn_ops.time_self_attention(q, k, v)
    q, k, v = (torch.randn((1, t, 8, 512), generator=g, device=cuda).view(1, t, 8, 1, 512)
               for _ in range(3))
    k2, blk = ta.temporal_attention.launches, ta.temporal_block_attention.launches
    out = attn_ops.time_self_attention(q, k, v)
    assert (ta.temporal_attention.launches, ta.temporal_block_attention.launches) == (k2, blk)
    assert (out - ta.temporal_attention_reference(q, k, v)).abs().max().item() == 0.0


@pytest.mark.gpu
def test_u2net_mask_on_the_card_matches_the_cpu(cuda):
    """The full U²-Net (random weights from a seed, random BatchNorm
    statistics) segments one 200 × 240 image on the card and on the CPU, in
    fp32 without TF32: the masks agree within 1e-3 (cuDNN's convolutions sum
    in other orders; the min-max normalisation scales those differences by
    1 / the range of d0)."""
    import copy

    from hi3d_tpu_torch.models.u2net import FrozenBatchNorm, U2Net, segment
    from hi3d_tpu_torch.pipelines.common import configure_precision

    configure_precision()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = U2Net(full=True).eval()
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.running_mean.normal_(0.0, 0.3)
                m.running_var.uniform_(0.5, 1.5)
        img = (torch.rand((200, 240, 3)) * 255).to(torch.uint8).numpy()
    ref = segment(model, img)
    out = segment(copy.deepcopy(model).to(cuda), img)
    assert out.device.type == "cuda" and out.shape == ref.shape == (200, 240)
    assert ref.std().item() > 0.05
    assert (out.cpu() - ref).abs().max().item() < 1e-3


@pytest.mark.gpu
def test_decode_tiled_on_the_card_matches_the_cpu(cuda):
    """A tiny fp32 VAE decodes a 20 × 28 latent in 8² tiles overlapping by 2
    on the card (its GroupNorm statistics on #9) and on the CPU (plain
    versions): within 1e-4 (outputs up to ~3), and #9 ran once per norm of
    each of the 3 × 5 tiles (rows at 0, 6, 12; columns at 0, 6, 12, 18 and
    20, the last pinned to the edge)."""
    import copy

    from hi3d_tpu_torch.models.layers import FoldedGroupNorm
    from hi3d_tpu_torch.models.vae import AutoencoderKL
    from hi3d_tpu_torch.pipelines.common import configure_precision

    configure_precision()
    dd = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3, "ch": 8,
          "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1, "attn_resolutions": [],
          "resolution": 64}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vae = AutoencoderKL(dd).eval()
        z = torch.randn((2, 4, 20, 28))
    with torch.no_grad():
        ref = vae.decode_tiled(z, tile=8, overlap=2)
        before = gn.group_stats.launches
        out = copy.deepcopy(vae).to(cuda).decode_tiled(z.to(cuda), tile=8, overlap=2)
    norms = sum(isinstance(m, FoldedGroupNorm) for m in vae.decoder.modules())
    assert gn.group_stats.launches - before == 15 * norms
    assert out.shape == ref.shape == (2, 3, 160, 224)
    assert (out.cpu() - ref).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_degradation_on_the_card_matches_the_cpu(cuda):
    """The stage-2 degradation (DegradedImages) on the card against the same
    call on the CPU: one RandomState seed for the plan, the noise fields
    drawn once on the CPU and handed to the card's run. The card's resizes
    and blurs round differently in the last bits, which can flip a uint8
    truncation before a JPEG: at most 1 grey level, mean ≤ 2e-3 levels,
    ≤ 2e-3 of the pixels off by more than half a level (the bounds the CPU
    suite holds the port's plan to against the JAX package)."""
    import numpy as np

    from hi3d_tpu_torch.data.degradation import DegradedImages
    from hi3d_tpu_torch.data.kernels import DEFAULT_DEGRADATION_OPT, sample_frame_kernels

    rnd = np.random.RandomState(0)
    b, t, hw = 3, 4, 128
    video = torch.from_numpy((rnd.rand(b, t, 3, hw, hw) * 2 - 1).astype(np.float32))
    masks = torch.from_numpy((rnd.rand(b, t, hw, hw) > 0.3).astype(np.float32))
    kernels = [sample_frame_kernels(DEFAULT_DEGRADATION_OPT, t, rnd) for _ in range(b)]
    k1, k2, ks = (torch.from_numpy(np.stack([k[i] for k in kernels])) for i in range(3))
    gen = torch.Generator().manual_seed(1)
    draws = []

    def record(kind, arg, device, rng, generator):
        out = DegradedImages._noise(kind, arg, device, rng, gen)
        draws.append(out)
        return out

    cpu, card = DegradedImages(), DegradedImages()
    cpu._noise = record
    card._noise = lambda *args: draws.pop(0).to(cuda)
    for seed in range(3):
        ref = cpu(video, masks, k1, k2, ks, rng=np.random.RandomState(seed))
        out = card(video.to(cuda), masks.to(cuda), k1.to(cuda), k2.to(cuda), ks.to(cuda),
                   rng=np.random.RandomState(seed))
        assert not draws and out.device.type == cuda.type
        d = (out.cpu() - ref).abs() * 127.5
        assert d.max().item() <= 1.0 + 1e-4, d.max().item()
        assert d.mean().item() <= 2e-3 and (d > 0.5).float().mean().item() <= 2e-3
        assert torch.equal(out[:, 0].cpu(), video[:, 0])


@pytest.mark.gpu
def test_degradation_is_deterministic_on_the_card(cuda):
    """One plan (the RandomState's seed) and one generator seed give the
    same degraded video bit for bit, run after run, on the card."""
    import numpy as np

    from hi3d_tpu_torch.data.degradation import DegradedImages
    from hi3d_tpu_torch.data.kernels import DEFAULT_DEGRADATION_OPT, sample_frame_kernels
    from hi3d_tpu_torch.pipelines.common import configure_precision

    configure_precision()
    rnd = np.random.RandomState(0)
    b, t, hw = 1, 4, 128
    video = torch.from_numpy((rnd.rand(b, t, 3, hw, hw) * 2 - 1).astype(np.float32)).to(cuda)
    masks = torch.from_numpy((rnd.rand(b, t, hw, hw) > 0.3).astype(np.float32)).to(cuda)
    k1, k2, ks = (torch.from_numpy(k)[None].to(cuda)
                  for k in sample_frame_kernels(DEFAULT_DEGRADATION_OPT, t, rnd))
    for seed in range(4):
        runs = [DegradedImages()(video, masks, k1, k2, ks, rng=np.random.RandomState(seed),
                                 generator=torch.Generator(cuda).manual_seed(seed))
                for _ in range(3)]
        assert all(torch.equal(runs[0], r) for r in runs[1:]), seed
        assert not torch.equal(runs[0], video)


CTX, TINY_T, TINY_RES = 32, 4, 64


class TinyImageEmbedder:
    """Set in `_tiny_engine` (the port's AbstractEmbedder subclass, made
    there so that importing this file needs no model code)."""


def _tiny_config(stage2: bool) -> dict:
    """A tiny stage-1 (or stage-2: 17 input channels, the DepthEmbedder and
    the per-frame VAE embedder) engine config, 2 sampler steps; head dim
    64, one the kernels take."""
    vae = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3, "ch": 8,
           "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1, "attn_resolutions": [],
           "resolution": TINY_RES}
    encoder = {"target": "sgm.models.autoencoder.AutoencoderKLModeOnly",
               "params": {"embed_dim": 4, "ddconfig": vae}}
    image = {"target": "test_torch_gpu.TinyImageEmbedder",
             "input_key": "cond_frames_without_noise"}
    elevation = {"target": "sgm.modules.encoders.modules.ConcatTimestepEmbedderND",
                 "input_key": "elevation", "params": {"outdim": 16}}
    aug = {"target": "sgm.modules.encoders.modules.ConcatTimestepEmbedderND",
           "input_key": "cond_aug", "params": {"outdim": 16}}
    frames = {"target": "sgm.modules.encoders.modules.VideoPredictionEmbedderWithEncoder",
              "input_key": "cond_frames",
              "params": {"n_cond_frames": 1, "n_copies": 1 if stage2 else TINY_T,
                         "encoder_config": encoder}}
    depth = {"target": "vtdm.encoders.DepthEmbedder", "input_key": "cond_frames",
             "params": {"shuffle_size": 3, "scale_factor": 1.0,
                        "model_kwargs": {"features": 16, "vit_width": 32, "vit_layers": 2,
                                         "vit_heads": 2, "hooks": [0, 1], "pos_grid": 4}}}
    return {
        "target": ("vtdm.vtdm_gen_stage2_degradeImage.VideoLDM" if stage2
                   else "vtdm.vtdm_gen_v01.VideoLDM"),
        "params": {
            "input_key": "video", "num_samples": TINY_T, "scale_factor": 0.18215,
            "en_and_decode_n_samples_a_time": 2, "compute_dtype": "bfloat16",
            "network_config": {
                "target": "sgm.modules.diffusionmodules.video_model.VideoUNet",
                "params": {"in_channels": 17 if stage2 else 8, "out_channels": 4,
                           "model_channels": 64, "num_res_blocks": 1, "channel_mult": [1, 2],
                           "attention_resolutions": [1, 2], "num_head_channels": 64,
                           "transformer_depth": 1, "context_dim": CTX,
                           "num_classes": "sequential", "adm_in_channels": 32,
                           "use_linear_in_transformer": True, "extra_ff_mix_layer": True,
                           "use_spatial_context": True, "merge_strategy": "learned_with_images",
                           "video_kernel_size": [3, 1, 1]}},
            "denoiser_config": {
                "target": "sgm.modules.diffusionmodules.denoiser.Denoiser",
                "params": {"scaling_config": {"target": "sgm.modules.diffusionmodules."
                                                        "denoiser_scaling.VScalingWithEDMcNoise"}}},
            "sampler_config": {
                "target": "sgm.modules.diffusionmodules.sampling.EulerEDMSampler",
                "params": {"num_steps": 2,
                           "discretization_config": {
                               "target": "sgm.modules.diffusionmodules.discretizer."
                                         "EDMDiscretization", "params": {"sigma_max": 700.0}},
                           "guider_config": {
                               "target": "sgm.modules.diffusionmodules.guiders."
                                         "LinearPredictionGuider",
                               "params": {"num_frames": TINY_T, "max_scale": 2.5}}}},
            "conditioner_config": {
                "target": "sgm.modules.GeneralConditioner",
                "params": {"emb_models": ([image, elevation, depth, frames, aug] if stage2
                                          else [image, elevation, frames, aug])}},
            "first_stage_config": {"target": "sgm.models.autoencoder.AutoencoderKL",
                                   "params": {"embed_dim": 4, "ddconfig": vae}},
        },
    }


def _tiny_engine(stage2: bool, device):
    global TinyImageEmbedder
    from hi3d_tpu_torch.conditioners import AbstractEmbedder
    from hi3d_tpu_torch.config import instantiate_from_config

    class TinyImageEmbedder(AbstractEmbedder):  # noqa: F811 — channel means, tiled
        def forward(self, image):
            feats = image.float().mean(dim=(2, 3))
            return feats.repeat(1, CTX // 3 + 1)[:, :CTX][:, None, :]

    with torch.random.fork_rng(devices=[]), device:
        torch.manual_seed(0)
        return instantiate_from_config(_tiny_config(stage2))


@pytest.mark.gpu
@pytest.mark.parametrize("stage2", [False, True])
def test_log_images_media_on_the_card(cuda, stage2):
    """The dump's media on the card at a tiny size: the JAX keys (stage 2
    adds depth-video and cond-video), (1, T, H, W, 3) float32, finite, the
    inputs and the caption image equal to the CPU run's, depth-video in
    [-1, 1]; the K3 kernel ran."""
    import copy

    import numpy as np

    engine = _tiny_engine(stage2, torch.device("cpu"))
    rnd = np.random.RandomState(1)
    video = torch.from_numpy((rnd.rand(2, TINY_T, 3, TINY_RES, TINY_RES) * 2 - 1)
                             .astype(np.float32))
    batch = {"video": video, "elevation": torch.tensor([10.0, -10.0]), "caption": ["a", "b"]}
    ref = engine.log_images(batch, n=1)
    card = copy.deepcopy(engine).to(cuda)
    before = gn.group_norm.launches
    got = card.log_images({**batch, "video": video.to(cuda),
                           "elevation": batch["elevation"].to(cuda)}, n=1)
    keys = {"inputs", "conditioning", "reconstructions", "samples"}
    keys |= {"depth-video", "cond-video"} if stage2 else set()
    assert set(got) == set(ref) == keys
    assert gn.group_norm.launches > before
    for k, v in got.items():
        assert v.dtype == np.float32 and v.shape == ref[k].shape and np.isfinite(v).all(), k
    assert got["samples"].shape == (1, TINY_T, TINY_RES, TINY_RES, 3)
    np.testing.assert_array_equal(got["inputs"], ref["inputs"])
    np.testing.assert_array_equal(got["conditioning"], ref["conditioning"])
    if stage2:
        assert -1.0 <= got["depth-video"].min() and got["depth-video"].max() <= 1.0


@pytest.mark.gpu
def test_export_reloads_strictly_on_the_card(cuda, tmp_path):
    """`--outckpt`'s export of an engine on the card: fp32, the UNet and the
    VAE under the reference prefixes, and a fresh engine's strict
    `init_from_ckpt` of the file gives back every tensor."""
    from hi3d_tpu_torch.convert import export_engine_state_dict, save_safetensors

    engine = _tiny_engine(False, cuda)
    with torch.no_grad():
        for p in engine.model.parameters():
            p.add_(0.01)  # not the seeded initial values
    sd = export_engine_state_dict(engine)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in sd.values())
    assert {k.split(".")[0] for k in sd} == {"model", "first_stage_model"}
    path = str(tmp_path / "export.safetensors")
    save_safetensors(sd, path)
    fresh = _tiny_engine(False, cuda)
    fresh.init_from_ckpt(path)
    for a, b in ((fresh.model, engine.model), (fresh.first_stage_model, engine.first_stage_model)):
        for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(p, q), n


@pytest.mark.gpu
def test_verify_weights_smoke_on_the_card(cuda, tmp_path):
    """`hi3d_tpu_torch.tools.verify_weights --smoke` on the card: a seeded
    `first_stage.pt` of the tiny stage-1 engine in DeepSpeed's layout
    covers the engine (PASS), and 2 sampler steps at 8 × 256² with it give
    finite frames."""
    import yaml

    from hi3d_tpu_torch.tools.verify_weights import verify

    engine = _tiny_engine(False, cuda)
    (tmp_path / "ckpts").mkdir()
    torch.save({"module": {f"module.{k}": v.cpu() for k, v in engine.state_dict().items()}},
               tmp_path / "ckpts" / "first_stage.pt")
    del engine
    config = tmp_path / "tiny-v01.yaml"
    config.write_text(yaml.safe_dump({"model": _tiny_config(False)}))
    results = {name: (status, detail) for name, status, detail in
               verify(str(tmp_path / "ckpts"), stage1_cfg=str(config), smoke=True, device="cuda")}
    assert results["stage1 engine (first_stage.pt)"][0] == "PASS", results
    status, detail = results["stage1 2-step sampling smoke"]
    assert status == "PASS" and "(8, 256, 256, 3)" in detail and "cuda" in detail, detail


@pytest.mark.gpu
def test_group_stats_on_the_time_stack_view(cuda):
    """#9 at SVD's time stack on the 64² latent, (B, C, T, H, W) = (1, 512,
    16, 64, 64) fp32 as `FoldedGroupNorm` reads it (the permuted frames
    copied to contiguous memory): (mean, inv_std) within 1e-4 of the plain
    version's largest magnitude, and the folded norm against F.group_norm."""
    import torch.nn.functional as F

    from hi3d_tpu_torch.models.vae import _norm

    g = torch.Generator(device=cuda).manual_seed(23)
    frames = torch.randn((16, 512, 64, 64), generator=g, device=cuda) * 3 + 1
    x = frames.view(1, 16, 512, 64, 64).transpose(1, 2).contiguous()
    for a, b in zip(gn.group_stats(x, 32, 1e-6), gn.group_stats_reference(x, 32, 1e-6)):
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-4
    norm = _norm(512).to(cuda)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1, generator=g)
        norm.bias.normal_(0.0, 0.1, generator=g)
        y, want = norm(x), F.group_norm(x, 32, norm.weight, norm.bias, 1e-6)
    assert ((y - want).abs().max() / want.abs().max()).item() < 1e-4


@pytest.mark.gpu
def test_ae_generator_pass_on_the_card_matches_the_cpu(cuda):
    """One generator pass of main path 12's AutoencoderTrainer
    (`chip_smoke.ae_trainer`: the VAE of configs/inference-v01.yaml, a
    3-layer PatchGAN with its logit conv ×1000, a random VGG16 LPIPS) on a
    1 × 128² input, on the card with TF32 off against a copy on the CPU that
    takes the card's LeakyReLU slopes (`chip_smoke.ae_pass_on_both`), within
    `chip_smoke.ae_pass_errors`' bounds: the reconstruction within 1e-4
    (summation order only); the loss, d_weight, the conv_out weight
    gradients of the NLL, of the GAN term on running statistics and of the
    loss, and the share of flipped slopes within 100× the reconstruction's
    error, at least 1e-4."""
    from chip_smoke import ae_pass_errors, ae_pass_on_both, ae_trainer

    x = torch.rand((1, 3, 128, 128), generator=torch.Generator().manual_seed(1)) * 2 - 1
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, want = ae_pass_on_both(ae_trainer("cpu"), x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert 0 < want["d_weight"] < 1e4
    errs, bounds = ae_pass_errors(got, want)
    assert all(errs[k] <= b for k, b in bounds.items()), (errs, bounds)


@pytest.mark.gpu
def test_text_tower_layer_norms_run_on_the_kernel(cuda):
    """The CLIP text tower in bf16 on the card: each LayerNorm32 (ln_1,
    ln_2 of every block, ln_final) is one #10 launch, and the output agrees
    with the same tower in fp32 on the CPU (relative L2, bf16's error)."""
    import copy

    from hi3d_tpu_torch.models.clip import CLIPTextTransformer

    torch.manual_seed(0)
    tower = CLIPTextTransformer(vocab_size=1000, width=768, layers=2, heads=12, proj_dim=768,
                                quick_gelu=True)
    ids = torch.randint(1, 999, (2, 77))
    cpu = copy.deepcopy(tower)
    with torch.no_grad():
        want_pooled, _, want = cpu(ids)
        tower.to(cuda, torch.bfloat16)
        ln.layer_norm.launches = 0
        pooled, _, got = tower(ids.to(cuda))
    assert ln.layer_norm.launches == 2 * 2 + 1
    for a, b in ((got["final"], want["final"]), (pooled, want_pooled)):
        assert ((a.float().cpu() - b).norm() / b.norm()).item() < 2e-2


@pytest.mark.gpu
def test_unet2d_launches_k1_and_k3_and_matches_plain(cuda):
    """A narrow UNetModel (two levels, self-attention at 256 and 64 tokens,
    head dim 64, a 77-token context) in bf16: K1 once per transformer block,
    K3 twice per ResBlock, once per SpatialTransformer and once for out.0,
    in both transformer layouts; the output agrees with its plain versions
    on the CPU in bf16 (relative L2)."""
    import copy

    from hi3d_tpu_torch.models.unet import UNetModel, _build_plan

    inp, mid, out = _build_plan(128, [1, 2], 1, [1, 2], [1, 1])
    specs = [s for block in inp + [mid] + out for s in block]
    n_attn, n_res = (sum(s[0] == kind for s in specs) for kind in ("attn", "res"))
    assert (n_attn, n_res) == (7, 8)
    for linear in (True, False):
        torch.manual_seed(1)
        net = UNetModel(in_channels=4, out_channels=4, model_channels=128, num_res_blocks=1,
                        channel_mult=[1, 2], attention_resolutions=[1, 2], num_head_channels=64,
                        context_dim=256, use_linear_in_transformer=linear).eval()
        for p in net.parameters():
            if not p.any():
                torch.nn.init.normal_(p, std=0.02)
        x, t, ctx = torch.randn(2, 4, 16, 16), torch.tensor([10.0, 900.0]), torch.randn(2, 77, 256)
        cpu = copy.deepcopy(net).to(torch.bfloat16)
        net.to(cuda, torch.bfloat16)
        fa.flash_attention.launches = gn.group_norm.launches = 0
        with torch.no_grad():
            out = net(x.to(cuda), t.to(cuda), context=ctx.to(cuda)).float().cpu()
            ref = cpu(x, t, context=ctx).float()
        assert fa.flash_attention.launches == n_attn
        assert gn.group_norm.launches == 2 * n_res + n_attn + 1
        assert ((out - ref).norm() / ref.norm()).item() < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bilinear", "cubic", "nearest"])
def test_antialiased_resize_on_the_card_matches_the_cpu(cuda, method):
    """jax.image.resize's semantics (`models.clip.image_resize`) on the card
    against the CPU: 512² → 299² and 64² → 160², fp32 (TF32 off)."""
    from hi3d_tpu_torch.models.clip import image_resize

    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for src, dst in ((512, 299), (64, 160)):
            x = torch.rand(2, 3, src, src, generator=torch.Generator().manual_seed(src))
            got = image_resize(x.to(cuda), (dst, dst), method).cpu()
            want = image_resize(x, (dst, dst), method)
            assert (got - want).abs().max().item() <= 1e-6
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


# ------------------------------------------------------ warping, JPEG, the VideoUNet options
WARP_TOL = 1e-5  # fp32 on the card against float64 on the CPU, of the largest entry


def _warp_rel_err(got, want):
    return ((got.double().cpu() - want).abs().max() / want.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "avg", "linear", "soft", "soft-clipeps"])
def test_softsplat_on_the_card_matches_the_cpu(cuda, mode):
    """softsplat forward and its input, flow and metric gradients on the
    card (scatter-add on atomics) against float64 on the CPU; the flow is
    quantised to 1/1024 px so both land on the same grid cells."""
    from hi3d_tpu_torch.ops.softsplat import softsplat

    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 3, 40, 56, generator=g)
    flow = torch.round((torch.rand(2, 2, 40, 56, generator=g) - 0.5) * 12 * 1024) / 1024
    metric = 0.5 + torch.rand(2, 1, 40, 56, generator=g)  # positive: linear's normaliser
    cot = torch.randn(2, 3, 40, 56, generator=g)
    res = {}
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        a, f, m = (v.detach().to(dev, dtype).requires_grad_() for v in (x, flow, metric))
        out = softsplat(a, f, m if mode.split("-")[0] in ("linear", "soft") else None, mode)
        (out * cot.to(dev, dtype)).sum().backward()
        res[str(dev)] = [out.detach(), a.grad, f.grad] + ([m.grad] if m.grad is not None else [])
    for got, want in zip(res["cuda"], res["cpu"]):
        assert _warp_rel_err(got, want) <= WARP_TOL


@pytest.mark.gpu
def test_correlation_on_the_card_matches_the_cpu(cuda):
    from hi3d_tpu_torch.ops.correlation import correlation

    g = torch.Generator().manual_seed(4)
    one, two = (torch.randn(2, 32, 24, 20, generator=g) for _ in range(2))
    cot = torch.randn(2, 81, 24, 20, generator=g)
    res = {}
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        a, b = (v.detach().to(dev, dtype).requires_grad_() for v in (one, two))
        out = correlation(a, b)
        (out * cot.to(dev, dtype)).sum().backward()
        res[str(dev)] = (out.detach(), a.grad, b.grad)
    for got, want in zip(res["cuda"], res["cpu"]):
        assert _warp_rel_err(got, want) <= WARP_TOL


@pytest.mark.gpu
def test_jpeg_fixtures_decode_to_their_goldens_on_the_card_host(cuda):
    """The port's PNG, JPEG and WebP decoders (no cv2) on the card's host
    against the committed cv2 goldens (tests/data/torch_{png,jpeg,webp}/
    goldens.json), and `load_image_rgb` on each."""
    import hashlib
    import json
    import os

    from hi3d_tpu_torch.utils.image import load_image_rgb, read_image

    for kind in ("torch_png", "torch_jpeg", "torch_webp"):
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", kind)
        with open(os.path.join(root, "goldens.json")) as f:
            goldens = json.load(f)
        for name, want in goldens.items():
            img = read_image(os.path.join(root, name))
            assert [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()] == \
                [want["shape"], want["sha256"]], name
            assert load_image_rgb(os.path.join(root, name)).shape == img.shape[:2] + (3,), name


@pytest.mark.gpu
def test_frame_self_context_launches_the_frame_kernel_twice(cuda):
    """A VideoUNet without the spatial context, called without a
    time_context, attends over the frames twice in every temporal block:
    twice K2's launches of the same UNet with it; without the temporal
    cross-attention once. The counts come from the modules
    (`frame_self_attentions`)."""
    from hi3d_tpu_torch.models.unet import VideoUNet
    from hi3d_tpu_torch.models.video_attention import SpatialVideoTransformer

    kw = dict(in_channels=8, out_channels=4, model_channels=64, num_res_blocks=1,
              channel_mult=[1, 2], attention_resolutions=[1, 2], num_head_channels=64,
              context_dim=48, num_classes="sequential", adm_in_channels=16,
              use_linear_in_transformer=True, extra_ff_mix_layer=True)
    x = torch.randn(2 * 4, 8, 8, 8, device=cuda, dtype=torch.bfloat16)
    ts = torch.rand(8, device=cuda)
    ctx = torch.randn(2, 1, 48, device=cuda, dtype=torch.bfloat16)
    y = torch.randn(2, 16, device=cuda, dtype=torch.bfloat16)
    got = {}
    for name, opts in (("spatial", dict(use_spatial_context=True)),
                       ("self", dict(use_spatial_context=False)),
                       ("none", dict(use_spatial_context=False,
                                     disable_temporal_crossattention=True))):
        net = VideoUNet(**kw, **opts).to(cuda, torch.bfloat16).eval()
        want = sum(m.frame_self_attentions() for m in net.modules()
                   if isinstance(m, SpatialVideoTransformer))
        ta.temporal_attention.launches = 0
        with torch.no_grad():
            out = net(x, ts, context=ctx, y=y, num_video_frames=4,
                      image_only_indicator=torch.zeros(2, 4, device=cuda))
        assert torch.isfinite(out).all()
        got[name] = ta.temporal_attention.launches
        assert got[name] == want
    assert got["self"] == 2 * got["spatial"] and got["none"] == got["spatial"] > 0


@pytest.mark.gpu
def test_group_moments_kernel_matches_plain(cuda):
    """#9's moments mode ((mean, M2) a group, two passes) at the time
    stacks' location-split shapes of latency serving (2 CFG copies × C ×
    T 16 × half the 64² or 16² locations, bf16), an fp32 group whose mean is
    far from its spread, clusters of 8 and a ragged group; a second call is
    bitwise the same; the launch counts as #9's."""
    g = torch.Generator(device=cuda).manual_seed(21)
    for shape, dtype, offset in (((2, 320, 16, 2048, 1), torch.bfloat16, 0.0),
                                 ((2, 1280, 16, 128, 1), torch.bfloat16, 0.0),
                                 ((1, 128, 16, 8192, 1), torch.float32, 100.0),
                                 ((3, 64, 5, 7, 1), torch.float32, 1.0)):
        x = (torch.randn(shape, generator=g, device=cuda) * 3 + offset).to(dtype)
        before = gn.group_stats.launches
        mean, m2 = gn.group_moments(x, 32)
        assert gn.group_stats.launches == before + 1
        ref_mean, ref_m2 = gn.group_moments_reference(x.double(), 32)
        assert _close_rel(mean.double(), ref_mean) and _close_rel(m2.double(), ref_m2), shape
        again = gn.group_moments(x, 32)
        assert torch.equal(again[0], mean) and torch.equal(again[1], m2)


@pytest.mark.gpu
def test_group_norm_apply_kernel_matches_plain(cuda):
    """K3 with given statistics against its plain version on the same
    statistics: the time stack's permuted (N, C, T, S, 1) view in bf16 with
    SiLU, a contiguous fp32 tensor, an uneven location block (ragged rows);
    one launch, counted as K3's."""
    g = torch.Generator(device=cuda).manual_seed(22)
    for shape, dtype, perm, act in (((2, 16, 320, 2048, 1), torch.bfloat16, True, "silu"),
                                    ((2, 640, 16, 512, 1), torch.float32, False, None),
                                    ((2, 64, 16, 21, 1), torch.bfloat16, False, "silu")):
        x = torch.randn(shape, generator=g, device=cuda).to(dtype)
        if perm:
            x = x.permute(0, 2, 1, 3, 4)
        c = x.shape[1]
        w, b = (torch.randn((c,), generator=g, device=cuda) for _ in range(2))
        stats = torch.stack([torch.randn((x.shape[0], 32), generator=g, device=cuda),
                             torch.rand((x.shape[0], 32), generator=g, device=cuda) + 0.5])
        before = gn.group_norm.launches
        out = gn.group_norm_apply(x, w, b, 32, stats.contiguous(), act)
        assert gn.group_norm.launches == before + 1
        ref = gn.group_norm_apply_reference(x, w, b, 32, stats, act)
        tol = 6e-2 if dtype == torch.bfloat16 else 1e-4
        assert out.is_contiguous() and (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.gpu
def test_split_group_norm_and_location_block_attention(cuda):
    """In a one-rank gloo group on the card: the time stack's GroupNorm
    with its statistics from #9's moments, combined over the group, then
    applied by K3, equals K3's GroupNorm of the whole tensor; and K2 on a
    block of the locations (the layout latency serving hands it) equals
    K2 on every location, sliced, bit for bit."""
    import os
    import socket

    import torch.distributed as tdist

    from hi3d_tpu_torch.models.layers import GroupNorm32
    from hi3d_tpu_torch.parallel.dist import FrameShard

    g = torch.Generator(device=cuda).manual_seed(23)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    tdist.init_process_group("gloo", rank=0, world_size=1)
    try:
        shard = FrameShard.split(2, 16, tdist.group.WORLD)
        norm = GroupNorm32(320, act="silu").to(cuda, torch.bfloat16)
        with torch.no_grad():
            norm.weight.normal_(generator=g)
            norm.bias.normal_(generator=g)
            x = torch.randn((2, 16, 320, 1024), generator=g, device=cuda,
                            dtype=torch.bfloat16).permute(0, 2, 1, 3).unsqueeze(-1)
            k3, k9 = gn.group_norm.launches, gn.group_stats.launches
            got = norm(x, shard=shard)
            assert (gn.group_norm.launches - k3, gn.group_stats.launches - k9) == (1, 1)
            want = norm(x)
        assert (got.float() - want.float()).abs().max().item() < 6e-2
    finally:
        tdist.destroy_process_group()
    q, k, v = (torch.randn((2, 16, 4096, 320), generator=g, device=cuda,
                           dtype=torch.bfloat16).view(2, 16, 4096, 5, 64) for _ in range(3))
    whole = ta.temporal_attention(q, k, v)
    a, b = 1365, 2730  # the middle of three blocks: 1365 locations, not a multiple of 8
    block = ta.temporal_attention(*(t[:, :, a:b].contiguous() for t in (q, k, v)))
    assert torch.equal(block, whole[:, :, a:b])
