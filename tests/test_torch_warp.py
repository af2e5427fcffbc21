"""Softmax splatting and the cost-volume correlation against the JAX package
on the CPU: the same seeded inputs (NCHW in the port, NHWC in JAX), every
splat mode and normaliser, forwards and the gradients of a fixed scalar
loss against `jax.grad`, fp32 within 1e-5 (relative to the largest entry
where values are large: the sums differ only in order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401

TOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _splat_inputs(seed=0, b=2, h=9, w=11, c=3):
    rnd = np.random.RandomState(seed)
    x = rnd.randn(b, h, w, c).astype(np.float32)
    flow = (rnd.rand(b, h, w, 2).astype(np.float32) - 0.5) * 6.0  # corners land outside too
    flow[0, 0, 0] = [0.0, 0.0]  # an integer landing point (zero fractions)
    flow[0, 1, 1] = [1.0, -1.0]
    metric = rnd.randn(b, h, w, 1).astype(np.float32)
    cot = rnd.randn(b, h, w, c).astype(np.float32)
    return x, flow, metric, cot


MODES = ["sum", "avg", "linear", "soft"] + [f"{m}-{p}" for m in ("avg", "linear", "soft")
                                            for p in ("addeps", "zeroeps", "clipeps")]


@pytest.mark.parametrize("mode", MODES)
def test_softsplat_matches_jax(mode):
    """Forward and the gradients of sum(out · cotangent) with respect to the
    input, the flow and the metric, against JAX's `softsplat` and
    `jax.grad`."""
    from hi3d_tpu.ops.softsplat import softsplat as jax_softsplat
    from hi3d_tpu_torch.ops.softsplat import softsplat

    x, flow, metric, cot = _splat_inputs()
    takes_metric = mode.split("-")[0] in ("linear", "soft")

    def jloss(a, f, m):
        return jnp.sum(jax_softsplat(a, f, m if takes_metric else None, mode) * cot)

    want = np.asarray(jax_softsplat(jnp.asarray(x), jnp.asarray(flow),
                                    jnp.asarray(metric) if takes_metric else None, mode))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(flow), jnp.asarray(metric))

    tx, tf, tm = (_nchw(a).requires_grad_() for a in (x, flow, metric))
    out = softsplat(tx, tf, tm if takes_metric else None, mode)
    _close(_nhwc(out), want)
    (out * _nchw(cot)).sum().backward()
    _close(_nhwc(tx.grad), jg[0])
    _close(_nhwc(tf.grad), jg[1])
    if takes_metric:
        _close(_nhwc(tm.grad), jg[2])


def test_splat_sum_matches_the_loop_and_refusals():
    """`splat_sum` against a direct loop over source pixels (the JAX test's
    golden), zero flow as the identity, and the mode/metric refusals."""
    from test_softsplat import numpy_splat_sum
    from hi3d_tpu_torch.ops.softsplat import softsplat, splat_sum

    x, flow, metric, _ = _splat_inputs(seed=1, b=1, h=5, w=6, c=2)
    _close(_nhwc(splat_sum(_nchw(x), _nchw(flow))), numpy_splat_sum(x, flow))
    zero = torch.zeros(1, 2, 5, 6)
    assert torch.equal(splat_sum(_nchw(x), zero), _nchw(x))
    with pytest.raises(ValueError, match="unknown"):
        softsplat(_nchw(x), _nchw(flow), None, "max")
    with pytest.raises(ValueError, match="no metric"):
        softsplat(_nchw(x), _nchw(flow), _nchw(metric), "avg")
    with pytest.raises(ValueError, match="metric"):
        softsplat(_nchw(x), _nchw(flow), None, "soft")


def test_correlation_matches_jax():
    """The 81-channel cost volume and the gradients of sum(out · cotangent)
    with respect to both inputs, against JAX's `correlation` and
    `jax.grad`, at an odd size with more channels than the displacement."""
    from hi3d_tpu.ops.correlation import correlation as jax_correlation
    from hi3d_tpu_torch.ops.correlation import (FunctionCorrelation, ModuleCorrelation,
                                                correlation)

    rnd = np.random.RandomState(2)
    one, two = (rnd.randn(2, 10, 13, 7).astype(np.float32) for _ in range(2))
    cot = rnd.randn(2, 10, 13, 81).astype(np.float32)
    want = np.asarray(jax_correlation(jnp.asarray(one), jnp.asarray(two)))
    jg = jax.grad(lambda a, b: jnp.sum(jax_correlation(a, b) * cot), argnums=(0, 1))(
        jnp.asarray(one), jnp.asarray(two))

    t1, t2 = (_nchw(a).requires_grad_() for a in (one, two))
    out = correlation(t1, t2)
    assert out.shape == (2, 81, 10, 13)
    _close(_nhwc(out), want)
    (out * _nchw(cot)).sum().backward()
    _close(_nhwc(t1.grad), jg[0])
    _close(_nhwc(t2.grad), jg[1])
    assert FunctionCorrelation is correlation
    assert torch.equal(ModuleCorrelation()(t1, t2), out)
    with pytest.raises(ValueError, match="shape"):
        correlation(t1, t2[:, :3])
