"""The port's CUDA and Triton kernels on the card, against their plain
PyTorch versions on the same inputs; forward and backward, and the autograd
wiring (every kernel output carries a grad_fn, gradients reach every input).

This file imports neither jax nor hi3d_tpu, so it runs on a torch-only GPU
host. There, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite). Every
test takes the `cuda` fixture and skips without a card.

Tolerances: bf16 inputs, fp32 accumulation on both sides; outputs are O(1)
(2e-2 absolute ≈ a few bf16 ulps; 6e-2 for GroupNorm outputs up to ~8) and
gradients are compared relative to their largest entry (2e-2).
"""

import pytest
import torch

from hi3d_tpu_torch.ops import flash_attention as fa
from hi3d_tpu_torch.ops import group_norm as gn
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
def test_temporal_attention_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for t in (16, 5, 32):
        q, k, v = (torch.randn((2, t, 64, 320), generator=g, device=cuda,
                               dtype=torch.bfloat16).view(2, t, 64, 5, 64) for _ in range(3))
        out = ta.temporal_attention(q, k, v)
        ref = ta.temporal_attention_reference(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() < 2e-2


@pytest.mark.gpu
def test_group_norm_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for shape in ((4, 320, 16, 16), (2, 640, 4, 8, 8)):
        x = torch.randn(shape, generator=g, device=cuda, dtype=torch.bfloat16)
        w = torch.randn((shape[1],), generator=g, device=cuda)
        out = gn.group_norm(x, w, w, 32, 1e-5, "silu")
        ref = gn.group_norm_reference(x, w, w, 32, 1e-5, "silu")
        assert (out.float() - ref.float()).abs().max().item() < 6e-2


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


@pytest.mark.gpu
def test_temporal_attention_backward_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    for t in (16, 5, 32):
        q, k, v, dout = (torch.randn((2, t, 64, 320), generator=g, device=cuda,
                                     dtype=torch.bfloat16).view(2, t, 64, 5, 64)
                         for _ in range(4))
        out = ta.temporal_attention(q, k, v)
        got = ta.temporal_attention_backward(q, k, v, out, dout)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(ta.temporal_attention_reference(*leaves), leaves, dout)
        for a, b in zip(got, want):
            assert _rel_err(a, b) < 2e-2


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
