"""The VideoUNet and embedder options the port took over last, against the
JAX package on the CPU in fp32.

Each VideoUNet variant is built at a tiny width in both packages; JAX's
random tree (zero-initialised leaves randomised) goes into the port twice,
through JAX's reference-name export and `load_reference_state_dict`, and
through `convert.load_flax_video_unet`; both give the same module, held
against JAX's output at rtol 1e-4, atol 1e-5 (fp32 on both sides, the sums
in other orders). The conditioning-frame embedder with a σ sampler is held
with its σ and noise pinned to JAX's draws.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_modules import UNET_KW, _nchw, _nhwc, _randomize

RTOL, ATOL = 1e-4, 1e-5
T = 4
CTX = 24  # the spatial context's width, unlike the transformers' 32 and 64

ONE_LEVEL = dict(channel_mult=[1], attention_resolutions=[1])  # a shorter JAX compile
VARIANTS = {  # the conv layout keeps both levels: its tree holds the down/up names too
    "num_heads": dict(num_head_channels=-1, num_heads=2, **ONE_LEVEL),
    "conv_projections": dict(use_linear_in_transformer=False),
    "frame_self_context": dict(use_spatial_context=False, **ONE_LEVEL),
    "time_context": dict(use_spatial_context=False, **ONE_LEVEL),
    "no_temporal_crossattention": dict(disable_temporal_crossattention=True, **ONE_LEVEL),
    "dropout": dict(dropout=0.1, **ONE_LEVEL),
}


def _inputs(seed=4):
    rnd = np.random.RandomState(seed)
    return dict(x=rnd.randn(2 * T, 8, 8, 8).astype(np.float32),
                timesteps=rnd.rand(2 * T).astype(np.float32) * 2.0,
                context=rnd.randn(2, 1, CTX).astype(np.float32),
                y=rnd.randn(2, 32).astype(np.float32),
                image_only_indicator=np.zeros((2, T), np.float32),
                time_context=rnd.randn(2, 3, 32).astype(np.float32))  # the block's width


def _jax_unet(kw, inp, seed=6):
    """JAX's VideoUNet of `kw`: its output and random tree."""
    from hi3d_tpu.models.unet import VideoUNet as JaxVideoUNet

    jm = JaxVideoUNet(**kw)
    args = {k: jnp.asarray(v) for k, v in inp.items() if k != "x"}
    x = jnp.asarray(inp["x"])
    shapes = jax.eval_shape(functools.partial(jm.init, num_video_frames=T),
                            jax.random.PRNGKey(0), x, **args)
    p = _randomize(shapes, seed)
    out = jax.jit(functools.partial(jm.apply, num_video_frames=T))(p, x, **args)
    return np.asarray(out), p


def _torch_call(tm, kw, inp):
    args = {k: torch.from_numpy(v) for k, v in inp.items() if k != "x"}
    return _nhwc(tm(_nchw(inp["x"]), num_video_frames=T, **args))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_video_unet_option_matches_jax(variant):
    """Each option against JAX's VideoUNet, the tree carried both ways."""
    from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch
    from hi3d_tpu_torch.convert import load_flax_video_unet, load_reference_state_dict
    from hi3d_tpu_torch.models.unet import VideoUNet

    kw = {**UNET_KW, "context_dim": CTX, **VARIANTS[variant]}
    inp = _inputs()
    if variant != "time_context":
        inp.pop("time_context")
    want, p = _jax_unet(kw, inp)
    assert np.abs(want).max() > 0.1
    by_export = VideoUNet(**kw)
    load_reference_state_dict(by_export, _export_tree(p, unet_path_to_torch, "model.diffusion_model."),
                              "model.diffusion_model.")
    by_tree = VideoUNet(**kw)
    load_flax_video_unet(by_tree, jax.tree_util.tree_map(np.asarray, p))
    for name, a in by_tree.state_dict().items():
        assert torch.equal(a, by_export.state_dict()[name]), name
    with torch.no_grad():
        got = _torch_call(by_tree, kw, inp)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_option_layouts():
    """The parameters each option makes or drops: 1×1-conv projections under
    the linear layout's names, no `attn2`/`norm2` without the temporal
    cross-attention, `attn2` sized from the block without the spatial
    context (its own frames or a time_context as wide), heads from
    `num_heads`."""
    from hi3d_tpu_torch.models.unet import VideoUNet

    def svt(**kw):
        return VideoUNet(**{**UNET_KW, "context_dim": CTX, **kw}).input_blocks[1][1]

    conv = svt(use_linear_in_transformer=False)
    assert conv.proj_in.weight.shape == (32, 32, 1, 1)
    assert conv.proj_out.weight.shape == (32, 32, 1, 1)
    assert not hasattr(svt(disable_temporal_crossattention=True).time_stack[0], "attn2")
    assert svt().time_stack[0].attn2.to_k.weight.shape == (32, CTX)
    assert svt(use_spatial_context=False).time_stack[0].attn2.to_k.weight.shape == (32, 32)
    heads = svt(num_head_channels=-1, num_heads=4).transformer_blocks[0].attn1
    assert (heads.heads, heads.dim_head) == (4, 8)


def test_frame_self_context_runs_frame_attention_twice(monkeypatch):
    """Without the spatial context and without a time_context, every
    temporal block attends over its frames twice (attn1 and attn2); with the
    spatial context once, and once without the temporal cross-attention."""
    from hi3d_tpu_torch.models.unet import VideoUNet
    from hi3d_tpu_torch.models.video_attention import SpatialVideoTransformer
    from hi3d_tpu_torch.ops import attention as attn_ops

    inp = _inputs()
    inp.pop("time_context")
    calls = []
    real = attn_ops.time_self_attention
    monkeypatch.setattr(attn_ops, "time_self_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    counts = {}
    for name, kw in (("spatial", {}), ("self", dict(use_spatial_context=False)),
                     ("none", dict(disable_temporal_crossattention=True))):
        calls.clear()
        net = VideoUNet(**{**UNET_KW, "context_dim": CTX, **kw})
        with torch.no_grad():
            _torch_call(net, kw, inp)
        counts[name] = len(calls)
    sites = sum(isinstance(m, SpatialVideoTransformer) for m in net.modules())  # depth 1
    assert sites == 7
    assert counts == {"spatial": sites, "self": 2 * sites, "none": sites}


def test_unet2d_dropout_is_inert():
    """UNetModel takes `dropout` and computes what it computes without it, as
    JAX's deterministic dropout does; JAX's output agrees."""
    from test_torch_unet2d import BASE, _inputs as inputs2d, _jax_unet as jax_unet2d
    from hi3d_tpu_torch.convert import load_flax_unet2d
    from hi3d_tpu_torch.models.unet import UNetModel

    kw = dict(num_classes=None, use_linear_in_transformer=True, num_head_channels=16,
              channel_mult=[1], attention_resolutions=[1], dropout=0.25)
    x, ts, ctx, _ = inputs2d(kw)
    jm, p = jax_unet2d(kw, x, ts, ctx, None, seed=6)
    want = jax.jit(jm.apply)(p, x, ts, context=ctx)
    tm = UNetModel(**{**BASE, **kw})
    load_flax_unet2d(tm, jax.tree_util.tree_map(np.asarray, p))
    plain = UNetModel(**{**BASE, **kw, "dropout": 0.0})
    plain.load_state_dict(tm.state_dict())
    tm.train()
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(ts), context=torch.from_numpy(ctx))
        ref = plain(_nchw(x), torch.from_numpy(ts), context=torch.from_numpy(ctx))
    assert torch.equal(got, ref)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_noised_cond_frame_embedder_matches_jax(monkeypatch):
    """VideoPredictionEmbedderWithEncoder with an EDMSampling σ sampler: one
    σ a video, repeated over its conditioning frames, times unit normals,
    added before the chunked encode; σ and the normals pinned to JAX's draws
    from its key. Without a generator the port adds no noise, as JAX adds
    none without a key; `sigma_cond_config` raises in both."""
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu.convert.jax_to_torch import _export_tree, vae_path_to_torch
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.convert import load_reference_state_dict

    dd = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3, "ch": 8,
          "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [], "resolution": 16}
    cfg = {"target": "sgm.modules.encoders.modules.VideoPredictionEmbedderWithEncoder",
           "params": {"n_cond_frames": 2, "n_copies": 3, "is_ae": True,
                      "en_and_decode_n_samples_a_time": 3,
                      "sigma_sampler_config": {
                          "target": "sgm.modules.diffusionmodules.sigma_sampling.EDMSampling",
                          "params": {"p_mean": -1.0, "p_std": 0.5}},
                      "encoder_config": {"target": "sgm.models.autoencoder.AutoencoderKLModeOnly",
                                         "params": {"embed_dim": 4, "ddconfig": dd}}}}
    je = jax_instantiate(cfg)
    je.init_params(jax.random.PRNGKey(0))
    je.encoder.params = _randomize(je.encoder.params, 3)
    te = instantiate_from_config(cfg)
    load_reference_state_dict(te.encoder, _export_tree(je.encoder.params, vae_path_to_torch, ""))

    vid = np.random.RandomState(2).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(je(jnp.asarray(vid), key))
    rng_s, rng_n = jax.random.split(key)
    sigmas = np.asarray(je.sigma_sampler(rng_s, 2))
    noise = np.asarray(jax.random.normal(rng_n, vid.shape, jnp.float32))
    monkeypatch.setattr(type(te), "draw", lambda self, v, g: (torch.from_numpy(sigmas),
                                                               _nchw(noise)))
    with torch.no_grad():
        got = te(_nchw(vid), generator=torch.Generator().manual_seed(0))
        clean = te(_nchw(vid))
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_nhwc(clean), np.asarray(je(jnp.asarray(vid), None)),
                               rtol=RTOL, atol=ATOL)
    assert not torch.allclose(got, clean)

    bad = {**cfg, "params": {**cfg["params"], "sigma_cond_config": {"target": "x"}}}
    with pytest.raises(NotImplementedError):
        instantiate_from_config(bad)
    with pytest.raises(NotImplementedError):
        jax_instantiate(bad)


def test_noised_cond_frame_embedder_draws_from_the_generator():
    """The port's own draws: one σ a video from the sampler on the given
    generator, the same generator seed giving the same noise."""
    from hi3d_tpu_torch.conditioners import VideoPredictionEmbedderWithEncoder
    from hi3d_tpu_torch.diffusion.sigma_sampling import EDMSampling

    emb = VideoPredictionEmbedderWithEncoder.__new__(VideoPredictionEmbedderWithEncoder)
    torch.nn.Module.__init__(emb)
    emb.n_cond_frames, emb.sigma_sampler = 2, EDMSampling(-1.0, 0.5)
    vid = torch.zeros(6, 3, 4, 4)
    s1, n1 = emb.draw(vid, torch.Generator().manual_seed(5))
    s2, n2 = emb.draw(vid, torch.Generator().manual_seed(5))
    assert s1.shape == (3,) and n1.shape == vid.shape
    assert torch.equal(s1, s2) and torch.equal(n1, n2)


def test_module_launch_count_is_the_plan():
    """chip_smoke's count of a VideoUNet forward's launches from its modules
    (`unet_module_launches`) equals the plan `expected_launches` builds from
    the config for configs/inference-v01.yaml's UNet; with the spatial
    context off, the frame kernel's count doubles and nothing else moves."""
    import chip_smoke
    from hi3d_tpu_torch.config import instantiate_from_config, load_config

    config = "configs/inference-v01.yaml"
    cfg = load_config(config)["model"]["params"]["network_config"]
    plan = chip_smoke.expected_launches(config, 1, "unet_grad", clip_size=16)
    counts = {}
    for name, over in (("configured", {}), ("options", chip_smoke.UNET_OPTIONS)):
        with torch.device("meta"):
            net = instantiate_from_config({**cfg, "params": {**cfg["params"], **over}})
        counts[name] = chip_smoke.unet_module_launches(net, 16)
    fwd = 2 if cfg["params"].get("use_checkpoint") else 1  # the blocks recomputed in backward
    for name in ("flash_attention", "temporal_attention", "layer_norm"):
        assert counts["configured"][name] * fwd == plan[name], name
    assert (counts["configured"]["group_norm"] - 1) * fwd + 1 == plan["group_norm"]  # out.0 once
    doubled = dict(counts["configured"], temporal_attention=2 * counts["configured"][
        "temporal_attention"])
    assert counts["options"] == doubled
