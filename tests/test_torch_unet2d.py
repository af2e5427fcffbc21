"""The port's 2-D UNetModel and IdentityWrapper against the JAX package's,
on the CPU in fp32, and the port's registry against every target of
hi3d_tpu/registry.py.

JAX's UNetModel is built at a tiny width, its params (zero-initialised
leaves randomised, so every layer matters) are carried into the port by
`convert.load_flax_unet2d`, and inputs come from numpy.random.RandomState.

Tolerance: relative L2 error ≤ 1e-5 of the output and of the parameter
gradient: both sides are fp32 and differ in summation order only.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401

REL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def randomize(params, seed):
    """Random values for every leaf: kernels and embeddings at 1/sqrt(fan-in),
    norm scales near 1, everything else ~0.1."""
    rnd = np.random.RandomState(seed)

    def leaf(path, v):
        name = path[-1].key
        if name in ("kernel", "embedding"):
            fan_in = np.prod(v.shape[:-1]) if name == "kernel" else v.shape[-1]
            val = rnd.randn(*v.shape) / np.sqrt(fan_in)
        elif name == "scale":
            val = 1.0 + 0.1 * rnd.randn(*v.shape)
        else:
            val = 0.1 * rnd.randn(*v.shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


BASE = dict(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=1,
            channel_mult=[1, 2], attention_resolutions=[1, 2], context_dim=24)
ONE_LEVEL = dict(channel_mult=[1], attention_resolutions=[1])
CASES = {
    # num_classes mode, transformer layout, heads and depth (one level where
    # the case needs no second, to keep JAX's compile short)
    "sequential-linear-list_depth": dict(num_classes="sequential", adm_in_channels=12,
                                         use_linear_in_transformer=True, num_head_channels=16,
                                         transformer_depth=[1, 2]),
    "int-conv-num_heads": dict(num_classes=5, use_linear_in_transformer=False, num_heads=2,
                               **ONE_LEVEL),
    "continuous-conv": dict(num_classes="continuous", use_linear_in_transformer=False,
                            num_head_channels=8, **ONE_LEVEL),
    "none-linear": dict(num_classes=None, use_linear_in_transformer=True, num_head_channels=16,
                        **ONE_LEVEL),
}
GRAD_CASE = dict(num_classes="sequential", adm_in_channels=12, use_linear_in_transformer=True,
                 num_head_channels=16, transformer_depth=[2], **ONE_LEVEL)


def _inputs(kw, seed=0):
    rnd = np.random.RandomState(seed)
    x = rnd.randn(2, 8, 8, 4).astype(np.float32)
    ts = np.array([3.0, 700.0], np.float32)
    ctx = rnd.randn(2, 5, 24).astype(np.float32)
    mode = kw["num_classes"]
    if mode == "sequential":
        y = rnd.randn(2, kw["adm_in_channels"]).astype(np.float32)
    elif mode == "continuous":
        y = rnd.rand(2).astype(np.float32)
    elif mode is not None:
        y = np.array([1, 4], np.int32)
    else:
        y = None
    return x, ts, ctx, y


def _jax_unet(kw, x, ts, ctx, y, seed):
    from hi3d_tpu.models.unet import UNetModel as JaxUNetModel

    jm = JaxUNetModel(**{**BASE, **kw}, attn_backend="xla")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, ts, context=ctx, y=y)
    return jm, randomize(shapes, seed)


def _port_unet(kw, params, **extra):
    from hi3d_tpu_torch.convert import load_flax_unet2d
    from hi3d_tpu_torch.models.unet import UNetModel

    tm = UNetModel(**{**BASE, **kw}, **extra)
    load_flax_unet2d(tm, jax.tree_util.tree_map(np.asarray, params))
    return tm


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _nchw(x):
    return _t(np.moveaxis(x, -1, 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_unet2d_matches_jax(case):
    kw = CASES[case]
    x, ts, ctx, y = _inputs(kw)
    jm, p = _jax_unet(kw, x, ts, ctx, y, seed=1)
    ref = np.asarray(jax.jit(jm.apply)(p, x, ts, context=ctx, y=y))
    tm = _port_unet(kw, p)
    with torch.no_grad():
        out = tm(_nchw(x), _t(ts), context=_t(ctx), y=_t(y))
    assert np.abs(ref).max() > 0.1
    assert _rel(np.moveaxis(out.numpy(), 1, -1), ref) <= REL


def test_unet2d_gradient_matches_jax():
    """Every parameter's gradient of Σ(out · cot) through the port's
    `use_checkpoint` (torch.utils.checkpoint), against jax.grad, carried
    into a second port UNet by the same converter as the weights."""
    kw = GRAD_CASE
    x, ts, ctx, y = _inputs(kw, seed=2)
    jm, p = _jax_unet(kw, x, ts, ctx, y, seed=3)
    cot = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda q: jnp.sum(jm.apply(q, x, ts, context=ctx, y=y) * cot)))(p)
    tm = _port_unet(kw, p, use_checkpoint=True)
    loss = (tm(_nchw(x), _t(ts), context=_t(ctx), y=_t(y)) * _nchw(cot)).sum()
    loss.backward()
    carried = _port_unet(kw, jgrads)
    want = dict(carried.named_parameters())
    got = torch.cat([p.grad.flatten() for _, p in tm.named_parameters()])
    ref = torch.cat([want[n].detach().flatten() for n, _ in tm.named_parameters()])
    assert all(p.grad is not None for p in tm.parameters())
    assert _rel(got.numpy(), ref.numpy()) <= REL


def test_unet2d_names_are_the_reference_checkpoints():
    """The port's state dict maps, key for key, onto JAX's tree through the
    JAX package's converter of reference 2-D UNet checkpoints (strict), so a
    released SD checkpoint's `model.diffusion_model.*` loads by name."""
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_unet2d_key
    from hi3d_tpu_torch.models.unet import UNetModel

    kw = CASES["sequential-linear-list_depth"]
    x, ts, ctx, y = _inputs(kw)
    _, p = _jax_unet(kw, x, ts, ctx, y, seed=5)
    sd = {k: v.numpy() for k, v in UNetModel(**{**BASE, **kw}).state_dict().items()}
    conv = convert_state_dict(sd, convert_unet2d_key, strict=True)
    flat = lambda t: {k for k, _ in jax.tree_util.tree_flatten_with_path(t)[0]}  # noqa: E731
    assert flat(conv) == flat(p)


def test_unet2d_refuses_a_stray_leaf():
    from hi3d_tpu_torch.convert import load_flax_unet2d
    from hi3d_tpu_torch.models.unet import UNetModel

    kw = CASES["none-linear"]
    x, ts, ctx, y = _inputs(kw)
    _, p = _jax_unet(kw, x, ts, ctx, y, seed=6)
    tree = jax.tree_util.tree_map(np.asarray, p)
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra"):
        load_flax_unet2d(UNetModel(**{**BASE, **kw}), tree)


def test_unet2d_needs_heads():
    """Neither num_heads nor num_head_channels: a ValueError, as JAX's
    `_heads_for` raises."""
    from hi3d_tpu.models.unet import UNetModel as JaxUNetModel
    from hi3d_tpu_torch.models.unet import UNetModel

    with pytest.raises(ValueError, match="num_heads or num_head_channels"):
        UNetModel(**BASE)
    x, ts, ctx, _ = _inputs({"num_classes": None})
    with pytest.raises(ValueError, match="num_heads or num_head_channels"):
        jax.eval_shape(JaxUNetModel(**BASE).init, jax.random.PRNGKey(0), x, ts, context=ctx)


def test_identity_wrapper_ignores_cond():
    """IdentityWrapper calls the UNet on (x, c_noise) and the extra keywords
    alone, whatever `cond` holds, as JAX's bound network does."""
    from hi3d_tpu.models.wrappers import IdentityWrapper as JaxIdentityWrapper
    from hi3d_tpu_torch.models.wrappers import IdentityWrapper

    kw = CASES["int-conv-num_heads"]
    x, ts, ctx, y = _inputs(kw, seed=7)
    jm, p = _jax_unet(kw, x, ts, ctx, y, seed=8)
    jnet = JaxIdentityWrapper(jm).bind(p)
    junk = {"crossattn": jnp.ones((2, 5, 24)), "vector": jnp.ones((2, 7))}
    ref = np.asarray(jax.jit(lambda c: jnet(x, ts, c, context=ctx, y=y))(junk))
    net = IdentityWrapper(_port_unet(kw, p))
    with torch.no_grad():
        a = net(_nchw(x), _t(ts), {"crossattn": torch.ones(2, 5, 24)}, context=_t(ctx), y=_t(y))
        b = net(_nchw(x), _t(ts), {}, context=_t(ctx), y=_t(y))
    assert torch.equal(a, b)
    assert _rel(np.moveaxis(a.numpy(), 1, -1), ref) <= REL


def test_registry_resolves_every_jax_target():
    """Every target of hi3d_tpu/registry.py builds a class of the port (or
    torch's own, for torch.nn.Identity), never one of the JAX package."""
    from hi3d_tpu.registry import _ALIASES
    from hi3d_tpu_torch.config import get_obj_from_str

    for name in _ALIASES:
        cls = get_obj_from_str(name)
        assert cls.__module__.startswith(("hi3d_tpu_torch.", "torch.")), (name, cls)
