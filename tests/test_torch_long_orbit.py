"""Long orbits (more than 32 frames) in the port against hi3d_tpu, on CPU.

Past 32 frames the port's frame-axis attention leaves K2 for #6
(`segment_attention` / `temporal_block_attention`, backward #7), at any
length. On the CPU the wrappers take their plain versions; the JAX side runs
its Pallas #6/#7 (`_fwd3`/`_bwd3`) in interpret mode, as
tests/test_temporal_kernel.py does, where `default_block` finds a block
(T = 136 here), else its einsum (`xla_attention_time`, T = 129 here).
Inputs come from numpy.random.RandomState; everything is fp32.

Tolerances: the kernel-level comparisons sum a few dozen products in another
order (1e-5 on O(1) outputs and lse, 1e-4 on gradients); the tiny UNet and
the end-to-end orbit keep those of tests/test_torch_modules.py (5e-4) and
tests/test_torch_slice.py (2e-3).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from hi3d_tpu.ops import attention as jax_attn
from hi3d_tpu.ops import temporal_attention as jax_ta
from hi3d_tpu_torch.ops import attention as attn_ops
from hi3d_tpu_torch.ops import temporal_attention as ta
from test_torch_slice import models  # noqa: F401  (module fixture: tiny stage-1 engines)

B, S, H, D = 2, 8, 2, 32  # S = 8 gives the JAX kernel a block at every T below


def _inputs(t, n=3, seed=0):
    rnd = np.random.RandomState(seed + t)
    return [rnd.randn(B, S * t, H, D).astype(np.float32) for _ in range(n)]


@pytest.fixture
def jax_lm_kernels(monkeypatch):
    """The JAX frame axis on its location-major kernels wherever they apply."""
    monkeypatch.setenv("HI3D_TEMPORAL_FUSED", "force")
    monkeypatch.setenv("HI3D_TEMPORAL_LAYOUT", "lm")


def _jax_block_attention(q, k, v, t):
    """JAX's segment-local attention on (B, S·T, H, D) tokens as its frame
    axis runs it: the Pallas #6 where `default_block` finds a block, else the
    einsum of `xla_attention_time` on the (B, T, S, H, D) view."""
    if jax_ta.default_block(t, S * t):
        return jax_ta.temporal_block_attention(q, k, v, t)

    def to5(x):
        return x.reshape(B, S, t, H, D).transpose(0, 2, 1, 3, 4)

    assert not jax_attn._temporal_fused_engages(to5(q), to5(k), to5(v))
    out = jax_attn.xla_attention_time(to5(q), to5(k), to5(v))
    return out.transpose(0, 2, 1, 3, 4).reshape(B, S * t, H, D)


@pytest.mark.parametrize("t", [33, 40, 48, 129, 136])
def test_block_attention_matches_jax_kernel(t, jax_lm_kernels):
    assert bool(jax_ta.default_block(t, S * t)) == (t != 129)
    q, k, v = _inputs(t)
    ref = np.asarray(_jax_block_attention(*map(jnp.asarray, (q, k, v)), t))
    out = ta.temporal_block_attention(*map(torch.from_numpy, (q, k, v)), t).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)

    def to3(x):  # the JAX kernel's (B·H, S·T, D) layout
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S * t, D)

    if jax_ta.default_block(t, S * t):
        _, lse_ref = jax_ta._fwd3(to3(q), to3(k), to3(v), D**-0.5,
                                  jax_ta.default_block(t, S * t), t)
    else:  # the einsum's logits, (B, H, S, T, T)
        seg = [to3(x).reshape(B, H, S, t, D) for x in (q, k, v)]
        lse_ref = jax.nn.logsumexp(
            jnp.einsum("bhsqd,bhskd->bhsqk", seg[0], seg[1]) * D**-0.5, axis=-1)
    _, lse = ta.temporal_block_attention_reference(
        *(torch.from_numpy(x).unflatten(1, (S, t)) for x in (q, k, v)))
    assert lse.shape == (B, H, S, t)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref).reshape(B, H, S, t), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("t", [33, 40, 48, 129, 136, 264])
def test_block_attention_grad_matches_jax(t, jax_lm_kernels):
    """Through the port's autograd Function (plain #7 on the CPU) against
    jax.grad through `_block_local` (`_bwd3` interpreted, at T = 264 on
    264-token blocks), or through the einsum where JAX has no block
    (T = 129)."""
    q, k, v, g = _inputs(t, n=4, seed=100)

    def loss(q_, k_, v_):
        return jnp.sum(_jax_block_attention(q_, k_, v_, t) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ta.temporal_block_attention(*leaves, t)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_frame_attention_route_splits_at_32():
    """One predicate picks the kernel: K2 up to 32 frames, #6 above, at the
    UNet's head dim 64; on the CPU both routes give the plain frame-axis
    softmax."""
    assert attn_ops.frame_attention_kernel(32, 64) == "temporal_attention"
    assert attn_ops.frame_attention_kernel(33, 64) == "temporal_block_attention"
    rnd = np.random.RandomState(7)
    for t in (32, 33):
        q, k, v = (torch.from_numpy(rnd.randn(2, t, 6, 2, 16).astype(np.float32))
                   for _ in range(3))
        out = attn_ops.time_self_attention(q, k, v)
        torch.testing.assert_close(out, ta.temporal_attention_reference(q, k, v), atol=1e-5,
                                   rtol=0)


def test_segment_attention_any_length_stays_on_block_kernel(monkeypatch):
    """A 200-frame clip (above #6's old 128-frame limit) goes through #6 and
    nothing else: on CPU tensors `segment_attention` runs, and the frame-axis
    dispatch never reaches K2."""
    t = 200
    assert attn_ops.frame_attention_kernel(t, 16) == "temporal_block_attention"
    calls = []

    def no_k2(*a, **kw):
        raise AssertionError("K2 reached at T = 200")

    def spy(q, k, v, *a, **kw):
        calls.append(q.shape[2])
        return ta.segment_attention(q, k, v, *a, **kw)

    monkeypatch.setattr(attn_ops, "temporal_attention", no_k2)
    monkeypatch.setattr(attn_ops, "segment_attention", spy)
    rnd = np.random.RandomState(200)
    q, k, v = (torch.from_numpy(rnd.randn(1, t, 3, 2, 16).astype(np.float32)) for _ in range(3))
    out = attn_ops.time_self_attention(q, k, v)
    assert calls == [t]
    torch.testing.assert_close(out, ta.temporal_attention_reference(q, k, v), atol=1e-5, rtol=0)
    seg = [x.transpose(1, 2) for x in (q, k, v)]
    out, lse = ta._block_forward(*seg, None)
    assert out.shape == seg[0].shape and lse.shape == (1, 2, 3, t)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_video_unet_long_clip_matches_jax(monkeypatch):
    """A tiny VideoUNet at T = 40 against the JAX one with its frame axis on
    the location-major Pallas #6 (interpreted), the port's on #6's plain
    version."""
    from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch
    from hi3d_tpu.models.unet import VideoUNet as JaxVideoUNet
    from hi3d_tpu_torch.convert import load_reference_state_dict
    from hi3d_tpu_torch.models.unet import VideoUNet
    from test_torch_modules import UNET_KW, _nchw, _nhwc, _randomize

    monkeypatch.setenv("HI3D_TEMPORAL_FUSED", "force")
    monkeypatch.setenv("HI3D_TEMPORAL_LAYOUT", "lm")
    calls = []
    fwd3 = jax_ta._fwd3
    monkeypatch.setattr(jax_ta, "_fwd3", lambda *a, **kw: calls.append(a[-1]) or fwd3(*a, **kw))

    rnd = np.random.RandomState(40)
    t = 40
    x = rnd.randn(t, 8, 8, 8).astype(np.float32)
    ts = rnd.rand(t).astype(np.float32) * 2.0
    ctx = rnd.randn(1, 1, 32).astype(np.float32)
    y = rnd.randn(1, 32).astype(np.float32)
    ind = np.zeros((1, t), np.float32)
    jm = JaxVideoUNet(**UNET_KW)
    shapes = jax.eval_shape(functools.partial(jm.init, num_video_frames=t),
                            jax.random.PRNGKey(0), x, ts, context=ctx, y=y,
                            image_only_indicator=ind)
    p = _randomize(shapes, 41)
    ref = np.asarray(jax.jit(functools.partial(jm.apply, num_video_frames=t))(
        p, x, ts, context=ctx, y=y, image_only_indicator=ind))
    assert calls and set(calls) == {t}  # the JAX frame axis ran #6
    tm = VideoUNet(**UNET_KW)
    load_reference_state_dict(tm, _export_tree(p, unet_path_to_torch, "model.diffusion_model."),
                              "model.diffusion_model.")
    with torch.no_grad():
        out = tm(_nchw(x), torch.from_numpy(ts), context=torch.from_numpy(ctx),
                 y=torch.from_numpy(y), num_video_frames=t,
                 image_only_indicator=torch.from_numpy(ind))
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(_nhwc(out), ref, atol=5e-4, rtol=0)


def test_generate_orbit_long_clip_matches_jax(models):  # noqa: F811
    """`generate_orbit` at clip_size 40 (the engine retargets its embedders
    and per-frame guider) against the JAX one with the same noise."""
    from hi3d_tpu.pipelines.i2v import generate_orbit as jax_generate_orbit
    from hi3d_tpu_torch.pipelines.i2v import generate_orbit

    jm, tm = models
    t, res = 40, 32
    rnd = np.random.RandomState(8)
    frames = rnd.rand(t, res, res, 3).astype(np.float32) * 2.0 - 1.0
    noise = rnd.randn(t, res // 8, res // 8, 4).astype(np.float32)
    cond_frames = (frames[:1] + 0.02 * rnd.randn(1, res, res, 3)).astype(np.float32)
    aug = np.array([0.02], np.float32)
    old = jm.num_samples, tm.num_samples
    jm.num_samples = tm.num_samples = t
    try:
        ref = jax_generate_orbit(
            jm, frames, elevation=5.0, rng=jax.random.PRNGKey(0), randn=jnp.asarray(noise),
            batch_overrides={"cond_frames": jnp.asarray(cond_frames),
                             "cond_aug": jnp.asarray(aug)},
        )
        out = generate_orbit(
            tm, frames, elevation=5.0, randn=noise,
            batch_overrides={"cond_frames": torch.from_numpy(cond_frames).permute(0, 3, 1, 2),
                             "cond_aug": torch.from_numpy(aug)},
        )
    finally:
        jm.num_samples, tm.num_samples = old
    assert out.shape == ref.shape == (t, res, res, 3)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)
