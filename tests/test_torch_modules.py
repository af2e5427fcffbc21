"""The port's modules against the JAX package's, on CPU, in fp32.

UNet-side modules and the VAE: the JAX module is built at a tiny width, its
params (zero-initialised leaves randomised, so every layer matters) are
exported to reference torch names with hi3d_tpu.convert.jax_to_torch, and
loaded into the port with strict=True. Towers go the other way: the port's
open_clip-layout tower and aesthetic MLP go into JAX through
hi3d_tpu.convert.torch_to_jax. Inputs come from numpy.random.RandomState.

Tolerance: both sides are fp32 and differ only in summation order (and the
port's one-pass GroupNorm moments), ~1e-6 relative per op; 1e-4 absolute on
O(1) outputs covers the few dozen ops of a block.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch, vae_path_to_torch
from hi3d_tpu_torch.convert import load_reference_state_dict

ATOL = 1e-4


def _randomize(params, seed):
    """Random values for every leaf (the structure may come from
    jax.eval_shape, which skips compiling the initialiser): kernels at
    1/sqrt(fan-in), norm scales near 1, everything else ~0.1."""
    rnd = np.random.RandomState(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "kernel":
            val = rnd.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif name == "scale":
            val = 1.0 + 0.1 * rnd.randn(*v.shape)
        else:
            val = 0.1 * rnd.randn(*v.shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _export_under(params, head, prefix):
    """Export a sub-module's tree as if it sat at UNet path `head`, then drop
    the torch `prefix` of that place: the names the port's module takes."""

    def path_fn(path):
        name = unet_path_to_torch(head + tuple(path))
        return name[len(prefix):] if name is not None else None

    return _export_tree(params, path_fn, "")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def test_resblock_2d_and_time_stack():
    from hi3d_tpu.models.layers import ResBlock as JaxResBlock
    from hi3d_tpu_torch.models.layers import ResBlock

    rnd = np.random.RandomState(0)
    x = rnd.randn(2, 6, 6, 32).astype(np.float32)
    emb = rnd.randn(2, 64).astype(np.float32)
    jm = JaxResBlock(out_channels=64, dims=2)
    p = _randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, emb), 1)
    ref = np.asarray(jax.jit(jm.apply)(p, x, emb))
    tm = ResBlock(32, 64, 64, dims=2)
    load_reference_state_dict(tm, _export_under(p, ("input_blocks_1_0", "spatial"), "input_blocks.1.0."))
    out = tm(_nchw(x), torch.from_numpy(emb))
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)

    # 3-D (3,1,1) time stack with per-(B, T) embeddings, (B, T, H, W, C) in JAX
    x5 = rnd.randn(2, 4, 3, 3, 32).astype(np.float32)
    emb5 = rnd.randn(2, 4, 64).astype(np.float32)
    jm = JaxResBlock(out_channels=32, dims=3, kernel_size=(3, 1, 1), exchange_temb_dims=True)
    p = _randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(1), x5, emb5), 2)
    ref = np.asarray(jax.jit(jm.apply)(p, x5, emb5))
    tm = ResBlock(32, 64, 32, dims=3, kernel_size=(3, 1, 1), exchange_temb_dims=True)
    load_reference_state_dict(tm, _export_under(p, ("input_blocks_1_0", "time_stack"),
                                                 "input_blocks.1.0.time_stack."))
    out = tm(torch.from_numpy(np.ascontiguousarray(x5.transpose(0, 4, 1, 2, 3))),
             torch.from_numpy(emb5))
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 4, 1), ref,
                               atol=ATOL, rtol=0)


def test_video_resblock():
    from hi3d_tpu.models.unet import VideoResBlock as JaxVideoResBlock
    from hi3d_tpu_torch.models.unet import VideoResBlock

    rnd = np.random.RandomState(1)
    t = 4
    x = rnd.randn(2 * t, 5, 5, 32).astype(np.float32)
    emb = rnd.randn(2 * t, 64).astype(np.float32)
    ind = np.zeros((2, t), np.float32)
    ind[1, 0] = 1.0  # one image-only frame exercises the blend's where()
    jm = JaxVideoResBlock(out_channels=48, video_kernel_size=(3, 1, 1))
    p = _randomize(jax.eval_shape(functools.partial(jm.init, num_video_frames=t),
                                  jax.random.PRNGKey(0), x, emb, image_only_indicator=ind), 3)
    ref = np.asarray(jax.jit(functools.partial(jm.apply, num_video_frames=t))(
        p, x, emb, image_only_indicator=ind))
    tm = VideoResBlock(32, 64, 48, (3, 1, 1))
    load_reference_state_dict(tm, _export_under(p, ("input_blocks_1_0",), "input_blocks.1.0."))
    out = tm(_nchw(x), torch.from_numpy(emb), t, torch.from_numpy(ind))
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)


def test_spatial_video_transformer():
    from hi3d_tpu.models.video_attention import SpatialVideoTransformer as JaxSVT
    from hi3d_tpu_torch.models.video_attention import SpatialVideoTransformer

    rnd = np.random.RandomState(2)
    t, c, ctx_dim = 4, 32, 24
    x = rnd.randn(2 * t, 4, 4, c).astype(np.float32)
    ctx = rnd.randn(2 * t, 1, ctx_dim).astype(np.float32)
    ind = np.zeros((2, t), np.float32)
    jm = JaxSVT(heads=2, dim_head=16, use_spatial_context=True, ff_in=True)
    p = _randomize(jax.eval_shape(functools.partial(jm.init, timesteps=t), jax.random.PRNGKey(0),
                                  x, ctx, image_only_indicator=ind), 4)
    ref = np.asarray(jax.jit(functools.partial(jm.apply, timesteps=t))(
        p, x, ctx, image_only_indicator=ind))
    tm = SpatialVideoTransformer(c, 2, 16, context_dim=ctx_dim)
    load_reference_state_dict(tm, _export_under(p, ("input_blocks_1_1",), "input_blocks.1.1."))
    out = tm(_nchw(x), torch.from_numpy(ctx), t, torch.from_numpy(ind))
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)


def test_spatial_transformer_with_multi_token_context():
    from hi3d_tpu.models.attention import SpatialTransformer as JaxST
    from hi3d_tpu_torch.models.attention import SpatialTransformer

    rnd = np.random.RandomState(3)
    x = rnd.randn(2, 4, 4, 32).astype(np.float32)
    ctx = rnd.randn(2, 5, 24).astype(np.float32)
    jm = JaxST(heads=2, dim_head=16)
    p = _randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, ctx), 5)
    ref = np.asarray(jax.jit(jm.apply)(p, x, ctx))
    tm = SpatialTransformer(32, 2, 16, context_dim=24)
    load_reference_state_dict(tm, _export_under(p, ("input_blocks_1_1",), "input_blocks.1.1."))
    out = tm(_nchw(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)


UNET_KW = dict(in_channels=8, out_channels=4, model_channels=32, num_res_blocks=1,
               channel_mult=[1, 2], attention_resolutions=[1, 2], num_head_channels=16,
               transformer_depth=1, context_dim=32, num_classes="sequential",
               adm_in_channels=32, use_linear_in_transformer=True, extra_ff_mix_layer=True,
               use_spatial_context=True, merge_strategy="learned_with_images",
               video_kernel_size=[3, 1, 1])


def test_video_unet():
    from hi3d_tpu.models.unet import VideoUNet as JaxVideoUNet
    from hi3d_tpu_torch.models.unet import VideoUNet

    rnd = np.random.RandomState(4)
    t = 4
    x = rnd.randn(2 * t, 8, 8, 8).astype(np.float32)
    ts = rnd.rand(2 * t).astype(np.float32) * 2.0
    ctx = rnd.randn(2, 1, 32).astype(np.float32)   # per video: broadcast per frame
    y = rnd.randn(2, 32).astype(np.float32)
    ind = np.zeros((2, t), np.float32)
    jm = JaxVideoUNet(**UNET_KW)
    shapes = jax.eval_shape(functools.partial(jm.init, num_video_frames=t),
                            jax.random.PRNGKey(0), x, ts, context=ctx, y=y,
                            image_only_indicator=ind)
    p = _randomize(shapes, 6)
    ref = np.asarray(jax.jit(functools.partial(jm.apply, num_video_frames=t))(
        p, x, ts, context=ctx, y=y, image_only_indicator=ind))
    tm = VideoUNet(**UNET_KW)
    load_reference_state_dict(tm, _export_tree(p, unet_path_to_torch, "model.diffusion_model."),
                              "model.diffusion_model.")
    out = tm(_nchw(x), torch.from_numpy(ts), context=torch.from_numpy(ctx),
             y=torch.from_numpy(y), num_video_frames=t, image_only_indicator=torch.from_numpy(ind))
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(_nhwc(out), ref, atol=5 * ATOL, rtol=0)


def test_vae_encode_decode():
    from hi3d_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
    from hi3d_tpu_torch.models.vae import AutoencoderKL

    dd = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3, "ch": 8,
          "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [], "resolution": 16}
    rnd = np.random.RandomState(5)
    x = rnd.rand(2, 16, 16, 3).astype(np.float32) * 2 - 1
    jm = JaxAutoencoderKL(dd)
    jm.init(jax.random.PRNGKey(0), image_hw=(16, 16))
    jm.params = _randomize(jm.params, 7)
    z_ref = np.asarray(jm.encode(jnp.asarray(x)))
    dec_ref = np.asarray(jm.decode(jnp.asarray(z_ref)))
    tm = AutoencoderKL(dd)
    load_reference_state_dict(tm, _export_tree(jm.params, vae_path_to_torch, ""))
    z = tm.encode(_nchw(x))
    np.testing.assert_allclose(_nhwc(z), z_ref, atol=ATOL, rtol=0)
    dec = tm.decode(_nchw(z_ref))
    np.testing.assert_allclose(_nhwc(dec), dec_ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("quick_gelu", [False, True])
def test_clip_tower_into_jax(quick_gelu):
    from hi3d_tpu.convert.torch_to_jax import convert_clip_visual_key, convert_state_dict
    from hi3d_tpu.models.clip import CLIPVisionTransformer as JaxCLIP
    from hi3d_tpu_torch.models.clip import CLIPVisionTransformer

    kw = dict(width=64, layers=2, heads=4, patch_size=14, image_size=28, output_dim=32,
              quick_gelu=quick_gelu)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = CLIPVisionTransformer(**kw)
    sd = {f"visual.{k}": v.numpy() for k, v in tm.state_dict().items()}
    params = convert_state_dict(sd, convert_clip_visual_key)
    x = np.random.RandomState(6).randn(2, 28, 28, 3).astype(np.float32)
    ref = np.asarray(jax.jit(JaxCLIP(**kw).apply)(params, x))
    out = tm(_nchw(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_aesthetic_mlp_into_jax():
    from hi3d_tpu.convert.torch_to_jax import convert_aesthetic_mlp
    from hi3d_tpu.models.clip import AestheticMLP as JaxMLP
    from hi3d_tpu_torch.models.clip import AestheticMLP

    tm = AestheticMLP()
    params = convert_aesthetic_mlp({k: v.numpy() for k, v in tm.state_dict().items()})
    x = np.random.RandomState(7).randn(3, 768).astype(np.float32)
    ref = np.asarray(JaxMLP().apply(params, x))
    np.testing.assert_allclose(tm.eval()(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=ATOL, rtol=0)


def test_clip_preprocessing_resizes():
    from hi3d_tpu.models.clip import resize_bicubic as jax_bicubic
    from hi3d_tpu.models.clip import resize_bilinear as jax_bilinear
    from hi3d_tpu_torch.models.clip import resize_bicubic, resize_bilinear

    x = np.random.RandomState(8).rand(2, 64, 48, 3).astype(np.float32) * 2 - 1
    xt = _nchw(x)
    np.testing.assert_allclose(_nhwc(resize_bicubic(xt, (224, 224))),
                               np.asarray(jax_bicubic(jnp.asarray(x), (224, 224))), atol=1e-5)
    # the matrices reproduce torch's antialiased bicubic
    tref = torch.nn.functional.interpolate(xt, size=(20, 30), mode="bicubic",
                                           antialias=True, align_corners=True)
    np.testing.assert_allclose(resize_bicubic(xt, (20, 30)).numpy(), tref.numpy(), atol=1e-5)
    np.testing.assert_allclose(_nhwc(resize_bilinear(xt, (40, 36))),
                               np.asarray(jax_bilinear(jnp.asarray(x), (40, 36))), atol=1e-5)


def test_diffusion_math_matches_jax():
    from hi3d_tpu.diffusion.discretization import EDMDiscretization as JaxEDM
    from hi3d_tpu.diffusion.guiders import LinearPredictionGuider as JaxGuider
    from hi3d_tpu.diffusion.samplers import EulerEDMSampler as JaxEuler
    from hi3d_tpu.diffusion.scaling import VScalingWithEDMcNoise as JaxScaling
    from hi3d_tpu_torch.diffusion.discretization import EDMDiscretization
    from hi3d_tpu_torch.diffusion.guiders import LinearPredictionGuider
    from hi3d_tpu_torch.diffusion.samplers import EulerEDMSampler
    from hi3d_tpu_torch.diffusion.scaling import VScalingWithEDMcNoise

    sig_ref = np.asarray(JaxEDM(sigma_max=700.0)(25))
    sig = EDMDiscretization(sigma_max=700.0)(25).numpy()
    np.testing.assert_array_equal(sig, sig_ref)
    s = sig[:-1]
    for a, b in zip(VScalingWithEDMcNoise()(torch.from_numpy(s)), JaxScaling()(jnp.asarray(s))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    rnd = np.random.RandomState(9)
    t = 4
    out2 = rnd.randn(2 * t, 3, 2, 2).astype(np.float32)
    g_ref = np.asarray(JaxGuider(2.5, t)(jnp.asarray(out2), None))
    np.testing.assert_allclose(LinearPredictionGuider(2.5, t)(torch.from_numpy(out2), None).numpy(),
                               g_ref, atol=1e-6)

    # one Euler step with CFG through a toy denoiser D(x, σ, c) = x·c_vec / (1 + σ)
    disc = {"target": "sgm.modules.diffusionmodules.discretizer.EDMDiscretization",
            "params": {"sigma_max": 700.0}}
    guide = {"target": "sgm.modules.diffusionmodules.guiders.LinearPredictionGuider",
             "params": {"num_frames": t, "max_scale": 2.5}}
    x = rnd.randn(t, 3, 2, 2).astype(np.float32)
    vec = rnd.randn(1, 3).astype(np.float32)
    js = JaxEuler(discretization_config=disc, guider_config=guide, num_steps=1)
    ts = EulerEDMSampler(discretization_config=disc, guider_config=guide, num_steps=1)

    def jden(xx, sigma, c):
        return xx * jnp.repeat(c["vector"], t, 0)[:, :, None, None] / (1.0 + sigma[:, None, None, None])

    def tden(xx, sigma, c):
        return xx * c["vector"].repeat_interleave(t, 0)[:, :, None, None] / (1.0 + sigma[:, None, None, None])

    ref = np.asarray(js(jden, jnp.asarray(x), {"vector": jnp.asarray(vec)},
                        uc={"vector": jnp.zeros_like(jnp.asarray(vec))}))
    out = ts(tden, torch.from_numpy(x), {"vector": torch.from_numpy(vec)},
             uc={"vector": torch.zeros(1, 3)})
    # x·√(1+σ₀²) ≈ 700·x and dt·d nearly cancel to O(1): fp32 rounding of the
    # O(1e3) terms leaves ~1e-4 absolute
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-4)


def test_concat_timestep_embedder_matches_jax():
    from hi3d_tpu.conditioners import ConcatTimestepEmbedderND as JaxEmb
    from hi3d_tpu_torch.conditioners import ConcatTimestepEmbedderND

    x = np.array([0.0, 10.0, 0.02], np.float32)
    np.testing.assert_allclose(ConcatTimestepEmbedderND(256)(torch.from_numpy(x)).numpy(),
                               np.asarray(JaxEmb(256)(jnp.asarray(x))), atol=1e-5)


def test_loader_strips_deepspeed_casts_and_is_strict():
    from hi3d_tpu_torch.models.layers import ResBlock

    tm = ResBlock(8, 16, 8).to(torch.bfloat16)
    sd = {f"module.model.diffusion_model.{k}": np.full(v.shape, 0.5, np.float32)
          for k, v in tm.state_dict().items()}
    load_reference_state_dict(tm, sd, "model.diffusion_model.")
    assert all(v.dtype == torch.bfloat16 and float(v.float().mean()) == 0.5
               for v in tm.state_dict().values())
    sd.pop(next(iter(sd)))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(tm, sd, "model.diffusion_model.")


def test_inference_config_targets_resolve():
    """configs/inference-v01.yaml names only targets the port registers; the
    sampler's steps_per_launch key is accepted (and ignored)."""
    from hi3d_tpu_torch.config import apply_dotlist, get_obj_from_str, load_config
    from hi3d_tpu_torch.diffusion.samplers import EulerEDMSampler

    cfg = load_config("configs/inference-v01.yaml")
    cfg = apply_dotlist(cfg, ["model.params.sampler_config.params.num_steps=3"])
    found = []

    def walk(node):  # the loss config is the training slice's
        if isinstance(node, dict):
            if "target" in node:
                found.append(node["target"])
            for k, v in node.items():
                if k != "loss_fn_config":
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(cfg)
    assert len(found) >= 15
    for target in found:
        assert get_obj_from_str(target).__module__.startswith("hi3d_tpu_torch.")
    sampler = EulerEDMSampler(**cfg["model"]["params"]["sampler_config"]["params"])
    assert sampler.num_steps == 3
