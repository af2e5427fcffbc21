"""The port's autoencoder surface against the JAX package, on the CPU in
fp32: SVD's temporal VideoDecoder in every time_mode and with skip_video,
a strict load of a reference-layout decoder state dict, AutoencodingEngine
(encode, decode, call, the KL log, max_batch_size chunking, posterior
samples from the port's generator), StandardDiffusionLoss's LPIPS branch,
and the registry's autoencoder targets.

Sizes: ch 32, mult (1, 2), one res block, 2 videos × 3 frames of 16²
latents (32² frames). Weights go from each JAX module's flax tree (every
leaf randomised) into the port through `convert.load_flax_tree`, except in
the reference-layout test, where one seeded torch-layout state dict goes to
JAX through its converter and to the port through
`convert.load_reference_state_dict`. Tolerance: fp32 forwards rtol 1e-4,
atol 1e-5 (summation order only).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_modules import _randomize
from hi3d_tpu_torch.convert import load_flax_tree, load_reference_state_dict, lpips_flax_name

RTOL, ATOL = 1e-4, 1e-5
T, VIDEOS = 3, 2
DD = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=4, out_ch=3, attn_resolutions=[],
          resolution=32, double_z=True)
MODES = ("conv-only", "all", "attn-only")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def latents():
    return np.random.RandomState(0).randn(VIDEOS * T, 16, 16, 4).astype(np.float32)


@pytest.fixture(scope="module")
def video_decoders(latents):
    """Per time_mode: the JAX VideoDecoder's random params and its jitted
    apply (one per skip_video), and the port's decoder loaded from them."""
    from hi3d_tpu.models.temporal_ae import VideoDecoder as JaxVideoDecoder
    from hi3d_tpu_torch.models.temporal_ae import VideoDecoder

    out = {}
    for i, mode in enumerate(MODES):
        jm = JaxVideoDecoder(time_mode=mode, video_kernel_size=(3, 1, 1), **DD)
        shapes = jax.eval_shape(functools.partial(jm.init, timesteps=T), jax.random.PRNGKey(0),
                                latents)
        params = _randomize(shapes, 10 + i)
        apply = {skip: jax.jit(functools.partial(jm.apply, timesteps=T, skip_video=skip))
                 for skip in (False, True)}
        tm = VideoDecoder(time_mode=mode, video_kernel_size=[3, 1, 1], **DD)
        load_flax_tree(tm, _np(params))
        out[mode] = params, apply, tm
    return out


@pytest.mark.parametrize("mode", MODES)
def test_video_decoder_matches_jax(video_decoders, latents, mode):
    params, apply, tm = video_decoders[mode]
    want = np.asarray(apply[False](params, latents))
    with torch.no_grad():
        got = tm(_nchw(latents), timesteps=T)
    assert got.shape == (VIDEOS * T, 3, 32, 32) and np.abs(want).max() > 0.1
    _close(_nhwc(got), want)


def test_video_decoder_skip_video_matches_jax_and_the_2d_decoder(video_decoders, latents):
    """time_mode "all" (every kind of video block) with skip_video against
    JAX, and equal to the 2-D `vae.Decoder` holding the same spatial
    weights."""
    from hi3d_tpu_torch.models.vae import Decoder

    params, apply, tm = video_decoders["all"]
    want = np.asarray(apply[True](params, latents))
    dec = Decoder(**DD)
    spatial = dec.state_dict()
    dec.load_state_dict({k: v for k, v in tm.state_dict().items() if k in spatial}, strict=True)
    with torch.no_grad():
        got = tm(_nchw(latents), timesteps=T, skip_video=True)
        plain = dec(_nchw(latents))
    _close(_nhwc(got), want)
    assert torch.equal(got, plain)


def test_video_decoder_loads_reference_state_dict(video_decoders, latents):
    """A seeded reference-layout conv-only decoder (`decoder.*`, with
    time_stack, mix_factor and conv_out.time_mix_conv) loads into the port
    with strict=True and into JAX through torch_to_jax.convert_vae_key; both
    decode alike. The port's flax names agree with JAX's exporter there."""
    from flax import traverse_util
    from hi3d_tpu.convert.jax_to_torch import vae_path_to_torch
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_vae_key
    from hi3d_tpu_torch.convert import flax_module_name

    params, apply, tm = video_decoders["conv-only"]
    g = torch.Generator().manual_seed(3)
    sd = {}
    for k, v in tm.state_dict().items():
        fan_in = v[0].numel() if v.ndim > 1 else 1
        sd[f"decoder.{k}"] = (torch.randn(v.shape, generator=g) / fan_in**0.5
                              + (k.endswith("weight") and v.ndim == 1)).numpy()
    jax_params = convert_state_dict(sd, convert_vae_key)["params"]["decoder"]
    want = np.asarray(apply[False]({"params": jax_params}, latents))
    load_reference_state_dict(tm, sd, "decoder.")
    with torch.no_grad():
        got = tm(_nchw(latents), timesteps=T)
    _close(_nhwc(got), want)
    for path in traverse_util.flatten_dict(params["params"]):
        assert "decoder." + flax_module_name(path[:-1]) == vae_path_to_torch(("decoder",)
                                                                              + path[:-1])


@pytest.fixture(scope="module")
def engines():
    """The JAX AutoencodingEngine (Encoder, 2-D Decoder, mode regularizer)
    with random weights, and the port's loaded from it."""
    from hi3d_tpu.models.autoencoding import AutoencodingEngine as JaxEngine
    from hi3d_tpu_torch.models.autoencoding import AutoencodingEngine

    cfg = {"encoder_config": {"target": "sgm.modules.diffusionmodules.model.Encoder",
                              "params": DD},
           "decoder_config": {"target": "sgm.modules.diffusionmodules.model.Decoder",
                              "params": DD},
           "regularizer_config": {
               "target": "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer",
               "params": {"sample": False}}}
    je = JaxEngine(**cfg)
    key = jax.random.PRNGKey(0)
    enc = jax.eval_shape(je.encoder.init, key, np.zeros((1, 32, 32, 3), np.float32))
    dec = jax.eval_shape(je.decoder.init, key, np.zeros((1, 16, 16, 4), np.float32))
    je.params = {"params": {"encoder": _randomize(enc, 20)["params"],
                            "decoder": _randomize(dec, 21)["params"]}}
    te = AutoencodingEngine(**cfg)
    load_flax_tree(te.encoder, _np(je.params["params"]["encoder"]))
    load_flax_tree(te.decoder, _np(je.params["params"]["decoder"]))
    return je, te


def test_engine_matches_jax(engines):
    """encode (with the KL log), decode and the call; 3 frames at
    max_batch_size 2 equal the unchunked engine."""
    je, te = engines
    x = np.tanh(np.random.RandomState(1).randn(3, 32, 32, 3)).astype(np.float32)
    z_want, log_want = jax.jit(functools.partial(je.encode, return_reg_log=True))(x)
    rec_want, _ = jax.jit(je.__call__)(x)
    with torch.no_grad():
        z, log = te.encode(_nchw(x), return_reg_log=True)
        rec = te.decode(z)
        rec_call, z_call = te(_nchw(x))
        te.max_batch_size = 2
        try:
            z2, rec2 = te.encode(_nchw(x)), te.decode(z)
        finally:
            te.max_batch_size = None
    assert z.shape == (3, 4, 16, 16) and rec.shape == (3, 3, 32, 32)
    _close(_nhwc(z), z_want)
    _close(log["kl_loss"], log_want["kl_loss"])
    _close(_nhwc(rec), rec_want)
    assert torch.equal(rec_call, rec) and torch.equal(z_call, z)
    _close(z2, z.numpy())  # other batch sizes, other conv algorithms
    _close(rec2, rec.numpy())


def test_gaussian_regularizer_samples_from_the_generator():
    """sample=True with a generator: mean + std·ε, ε the generator's next
    normal draw; without one (or sample=False), the mean; the KL log is the
    batch mean of ½Σ(μ² + σ² − 1 − log σ²), as JAX's."""
    from hi3d_tpu.models.autoencoding import DiagonalGaussianRegularizer as JaxReg
    from hi3d_tpu_torch.models.autoencoding import DiagonalGaussianRegularizer

    moments = np.random.RandomState(2).randn(2, 8, 5, 5).astype(np.float32)
    reg = DiagonalGaussianRegularizer(sample=True)
    z, log = reg(torch.from_numpy(moments), torch.Generator().manual_seed(7))
    eps = torch.randn((2, 4, 5, 5), generator=torch.Generator().manual_seed(7))
    mean, logvar = torch.from_numpy(moments).chunk(2, dim=1)
    torch.testing.assert_close(z, mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps)
    assert torch.equal(reg(torch.from_numpy(moments))[0], mean)
    _, want = JaxReg(sample=False)(jnp.asarray(np.moveaxis(moments, 1, -1)))
    _close(log["kl_loss"], want["kl_loss"])


def test_lpips_diffusion_loss_matches_jax():
    """StandardDiffusionLoss(loss_type="lpips") on a 3-channel toy output,
    σ and ε pinned, the port's LPIPS loaded from JAX's (random) weights: the
    (B,) distances agree, unweighted by σ; a 4-channel output raises in both
    packages (the port a ValueError that says why)."""
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu_torch.config import instantiate_from_config

    loss_cfg = {"target": "sgm.modules.diffusionmodules.loss.StandardDiffusionLoss", "params": {
        "sigma_sampler_config": {
            "target": "sgm.modules.diffusionmodules.sigma_sampling.EDMSampling"},
        "loss_weighting_config": {
            "target": "sgm.modules.diffusionmodules.loss_weighting.VWeighting"},
        "loss_type": "lpips", "num_frames": 1}}
    den = {"target": "sgm.modules.diffusionmodules.denoiser.Denoiser", "params": {
        "scaling_config": {
            "target": "sgm.modules.diffusionmodules.denoiser_scaling.VScalingWithEDMcNoise"}}}
    rnd = np.random.RandomState(4)
    x = np.tanh(rnd.randn(2, 16, 16, 3)).astype(np.float32)
    sig, eps = np.array([0.4, 3.0], np.float32), rnd.randn(2, 16, 16, 3).astype(np.float32)
    mix = (rnd.randn(3, 3) / 2).astype(np.float32)

    jl, jd = jax_instantiate(loss_cfg), jax_instantiate(den)
    jl.parity_sigmas, jl.parity_noise = sig, eps
    jl.lpips_params = _randomize(jax.eval_shape(jl.lpips.init, jax.random.PRNGKey(0), x, x), 5)
    jnet = lambda v, c_noise, cond, **kw: jnp.tanh(v @ mix)  # noqa: E731
    want = np.asarray(jax.jit(lambda v: jl(jnet, jd, {}, v, {}, jax.random.PRNGKey(0)))(x))

    tl, td = instantiate_from_config(loss_cfg), instantiate_from_config(den)
    load_flax_tree(tl.lpips, _np(jl.lpips_params), lpips_flax_name)
    tl.parity_sigmas, tl.parity_noise = torch.from_numpy(sig), _nchw(eps)
    tmix = torch.from_numpy(mix)
    tnet = lambda v, c_noise, cond, **kw: torch.tanh(  # noqa: E731
        torch.einsum("nchw,cd->ndhw", v, tmix))
    got = tl(tnet, td, {}, _nchw(x), {})
    assert got.shape == (2,) and want.shape == (2,)
    _close(got, want)

    x4 = np.zeros((1, 16, 16, 4), np.float32)
    jl4 = jax_instantiate(loss_cfg)
    with pytest.raises((TypeError, ValueError)):
        jl4.get_loss(jnp.asarray(x4), jnp.asarray(x4), None)
    with pytest.raises(ValueError, match="3-channel"):
        tl.get_loss(_nchw(x4), _nchw(x4), None)


def test_registry_resolves_every_autoencoder_target():
    """Every autoencoder target of the JAX registry resolves to the port's
    class of the same name; a Legacy (`ddconfig`) config fails in both."""
    from hi3d_tpu import registry as jax_registry
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu_torch.config import get_obj_from_str, instantiate_from_config

    targets = [k for k in jax_registry._ALIASES
               if k.startswith(("sgm.models.autoencoder.", "sgm.modules.autoencoding.",
                                "sgm.modules.diffusionmodules.model."))]
    assert len(targets) == 18
    for t in targets:
        port, jax_cls = get_obj_from_str(t), jax_registry.resolve(t)
        assert port.__module__.startswith("hi3d_tpu_torch.models."), t
        assert port.__name__ == jax_cls.__name__, t
    legacy = {"target": "sgm.models.autoencoder.AutoencodingEngineLegacy",
              "params": {"ddconfig": DD, "embed_dim": 4}}
    with pytest.raises(TypeError):
        jax_instantiate(legacy)
    with pytest.raises(TypeError, match="ddconfig"):
        instantiate_from_config(legacy)


def test_svd_first_stage_config_builds_the_video_engine():
    """The port's copy of SVD's first_stage_config builds an engine whose
    decoder is the conv-only VideoDecoder (on the meta device)."""
    from hi3d_tpu_torch.config import instantiate_from_config, load_config
    from hi3d_tpu_torch.models.autoencoding import SVD_FIRST_STAGE_CONFIG
    from hi3d_tpu_torch.models.temporal_ae import AE3DConv, VideoDecoder, VideoResBlock

    with torch.device("meta"):
        engine = instantiate_from_config(load_config(SVD_FIRST_STAGE_CONFIG))
    dec = engine.decoder
    assert isinstance(dec, VideoDecoder) and dec.time_mode == "conv-only"
    assert isinstance(dec.conv_out, AE3DConv) and dec.conv_out.time_mix_conv.kernel_size == (3, 1, 1)
    assert isinstance(dec.mid.block_1, VideoResBlock)
    assert engine.encoder.conv_out.out_channels == 8
