"""The autoencoder GAN surface of the port against the JAX package, on the
CPU in fp32: LPIPS, the PatchGAN discriminator (BatchNorm and ActNorm), the
generator and discriminator passes of GeneralLPIPSWithDiscriminator (2-D,
`dims=3`, `disc_start` gating), LatentLPIPS, the VQ quantizers on their
draw-free parts and the EMA update, and two alternating AutoencoderTrainer
steps.

Weights go from each JAX module's flax tree (every leaf randomised, so every
layer matters) into the port through `convert.load_flax_tree`; inputs come
from numpy.random.RandomState. Tolerance: fp32 forwards rtol 1e-4, atol
1e-5 (both sides differ only in summation order); where a value is a ratio
of gradient norms or an Adam update, the test says its own.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_modules import _randomize
from hi3d_tpu_torch.convert import (discriminator_flax_name, flax_module_name, load_flax_tree,
                                    lpips_flax_name)

RTOL, ATOL = 1e-4, 1e-5
DD = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=4, attn_resolutions=[],
          resolution=32, double_z=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _bn_stats(stats, seed):
    """Running statistics a trained BatchNorm could hold: means ~0.1, variances
    in [1, 1.3)."""
    rnd = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(0.1 * rnd.randn(*v.shape) if p[-1].key == "mean"
                                 else 1.0 + 0.3 * rnd.rand(*v.shape), jnp.float32), stats)


@pytest.fixture(scope="module")
def lpips_pair():
    """The JAX LPIPS with random weights and the port's loaded from it."""
    from hi3d_tpu.models.lpips import LPIPS as JaxLPIPS
    from hi3d_tpu_torch.models.lpips import LPIPS

    x = np.zeros((1, 32, 32, 3), np.float32)
    jm = JaxLPIPS()
    params = _randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x), 3)
    # the heads are non-negative, as trained ones are: a distance ≥ 0
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.abs(v) if p[1].key.startswith("lin") else v, params)
    tm = LPIPS()
    load_flax_tree(tm, _np(params), lpips_flax_name)
    return jm, params, tm


def test_lpips_matches_jax_and_is_zero_on_equal_images(lpips_pair):
    jm, params, tm = lpips_pair
    rnd = np.random.RandomState(1)
    x, y = (np.tanh(rnd.randn(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(jm.apply)(params, x, y))
    got = tm(_nchw(x), _nchw(y))
    assert got.shape == (2,) and want.min() > 0
    _close(got, want)
    assert torch.equal(tm(_nchw(x), _nchw(x)), torch.zeros(2))


def test_lpips_loads_reference_files(tmp_path):
    """A torchvision-layout VGG16 and a `vgg.pth` of heads (seeded) load
    into the port's LPIPS with strict=True, on torchvision's indices; the
    JAX package maps `features.2`/`features.7` to convs its module lacks."""
    from hi3d_tpu.models.lpips import convert_lpips_key as jax_key
    from hi3d_tpu_torch.models.lpips import LPIPS, _CONVS, TAP_CHANNELS, load_lpips_params

    g = torch.Generator().manual_seed(0)
    vgg = {}
    for i, (cin, cout) in _CONVS.items():
        vgg[f"features.{i}.weight"] = torch.randn(cout, cin, 3, 3, generator=g)
        vgg[f"features.{i}.bias"] = torch.randn(cout, generator=g)
    vgg["classifier.0.weight"] = torch.randn(4, 8, generator=g)
    heads = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
             for i, c in enumerate(TAP_CHANNELS)}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(heads, tmp_path / "vgg.pth")
    tm = LPIPS()
    tm.load_state_dict(load_lpips_params(str(tmp_path / "vgg.pth"), str(tmp_path / "vgg16.pth")),
                       strict=True)
    assert torch.equal(getattr(tm.net.slice1, "2").weight, vgg["features.2.weight"])
    assert torch.equal(getattr(tm.net.slice2, "7").bias, vgg["features.7.bias"])
    assert torch.equal(tm.lin4.model[1].weight, heads["lin4.model.1.weight"])
    assert jax_key("features.2.weight") == ("net", "conv2")  # the JAX tree has conv3


@pytest.mark.parametrize("use_actnorm", [False, True], ids=["batchnorm", "actnorm"])
def test_nlayer_discriminator_matches_jax(use_actnorm):
    """Logits in every statistics mode, and (BatchNorm) the running
    statistics after a training call, against flax's BatchNorm."""
    from hi3d_tpu.models.discriminator import NLayerDiscriminator as JaxDisc
    from hi3d_tpu_torch.models.discriminator import NLayerDiscriminator

    rnd = np.random.RandomState(2)
    x = rnd.randn(2, 32, 32, 3).astype(np.float32)
    jm = JaxDisc(n_layers=3, use_actnorm=use_actnorm)
    shapes = jax.eval_shape(functools.partial(jm.init, train=True), jax.random.PRNGKey(0), x)
    variables = {"params": _randomize(shapes["params"], 4)}
    if not use_actnorm:
        variables["batch_stats"] = _bn_stats(shapes["batch_stats"], 5)
    tm = NLayerDiscriminator(n_layers=3, use_actnorm=use_actnorm)
    load_flax_tree(tm, _np(variables), discriminator_flax_name(3))
    want_eval = np.asarray(jax.jit(jm.apply)(variables, x))
    with torch.no_grad():
        _close(_nhwc(tm(_nchw(x), "eval")), want_eval)
        if use_actnorm:
            return
        want_train, mut = jax.jit(functools.partial(jm.apply, train=True,
                                                    mutable=["batch_stats"]))(variables, x)
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        _close(_nhwc(tm(_nchw(x), "batch")), want_train)
        assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())
        _close(_nhwc(tm(_nchw(x), "train")), want_train)
    for n, idx in ((1, 3), (2, 6), (3, 9)):
        bn = tm.main[idx]
        _close(bn.running_mean, mut["batch_stats"][f"norm{n}"]["mean"], msg=f"norm{n} mean")
        _close(bn.running_var, mut["batch_stats"][f"norm{n}"]["var"], msg=f"norm{n} var")


@pytest.fixture(scope="module")
def gan_pair(lpips_pair):
    """A JAX GeneralLPIPSWithDiscriminator state and a 2-D decoder (random
    weights), and the port's loss and decoder loaded from them."""
    from hi3d_tpu.models.discriminator import GeneralLPIPSWithDiscriminator as JaxLoss
    from hi3d_tpu.models.vae import Decoder as JaxDecoder
    from hi3d_tpu_torch.models.discriminator import GeneralLPIPSWithDiscriminator
    from hi3d_tpu_torch.models.vae import Decoder

    kw = dict(disc_weight=0.7, disc_num_layers=2, logvar_init=0.3,
              regularization_weights={"kl_loss": 0.5})
    z = np.zeros((1, 16, 16, 4), np.float32)
    jdec = JaxDecoder(**{k: v for k, v in DD.items() if k != "double_z"})
    dec_params = _randomize(jax.eval_shape(jdec.init, jax.random.PRNGKey(0), z), 6)["params"]
    tdec = Decoder(**DD)
    load_flax_tree(tdec, _np(dec_params))
    jl = JaxLoss(disc_start=0, **kw)
    disc_shapes = jax.eval_shape(functools.partial(jl.discriminator.init, train=True),
                                 jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    disc = {"params": _randomize(disc_shapes["params"], 7),
            "batch_stats": _bn_stats(disc_shapes["batch_stats"], 8)}
    # logits ~100: ‖∇nll‖ / ‖∇g‖ ~ 300, inside the adaptive weight's clip at 1e4
    disc["params"]["conv_out"]["kernel"] = 100.0 * disc["params"]["conv_out"]["kernel"]
    state = {"logvar": jnp.float32(0.3), "discriminator": disc, "lpips": lpips_pair[1]}
    return jdec, dec_params, tdec, kw, state


@pytest.mark.parametrize("case", ["2d", "dims3", "gated"])
def test_gan_loss_passes_match_jax(gan_pair, case):
    """Generator pass (every log key, the adaptive d_weight from the decoder's
    conv_out kernel and bias) and discriminator pass (loss, logits, the
    running statistics after both training calls): 2-D frames; (B, T, H, W,
    C) videos with dims=3; and disc_start 5 at step 1, where the GAN terms
    are 0. d_weight is a ratio of gradient norms: rtol 1e-4 holds."""
    from hi3d_tpu.models.discriminator import GeneralLPIPSWithDiscriminator as JaxLoss
    from hi3d_tpu_torch.models.discriminator import GeneralLPIPSWithDiscriminator

    jdec, dec_params, tdec, kw, state = gan_pair
    dims = 3 if case == "dims3" else 2
    start = 5 if case == "gated" else 0
    kw = {**kw, "perceptual_weight": 1.0 if case == "2d" else 0.0}  # LPIPS's grad compiles once
    jl = JaxLoss(disc_start=start, dims=dims, **kw)
    tl = GeneralLPIPSWithDiscriminator(disc_start=start, dims=dims, **kw)
    load_flax_tree(tl.discriminator, _np(state["discriminator"]), discriminator_flax_name(2))
    if tl.perceptual_loss is not None:
        load_flax_tree(tl.perceptual_loss, _np(state["lpips"]), lpips_flax_name)
    with torch.no_grad():
        tl.logvar.fill_(0.3)

    rnd = np.random.RandomState(9)
    z = rnd.randn(2, 16, 16, 4).astype(np.float32)
    x = np.tanh(rnd.randn(2, 32, 32, 3)).astype(np.float32)
    kl = np.float32(0.25)
    xin = x.reshape(1, 2, 32, 32, 3) if dims == 3 else x

    @jax.jit
    def generator_pass(state, xin, dec_params):
        def decode_fn(conv_out):
            return jdec.apply({"params": {**dec_params, "conv_out": conv_out}}, z)

        return jl.generator_loss(
            state, xin, decode_fn(dec_params["conv_out"]), regularization_log={"kl_loss": kl},
            global_step=1, train=True, decode_fn=decode_fn,
            last_layer_params=dec_params["conv_out"])

    want, wlog = generator_pass(state, xin, dec_params)
    rec = tdec(_nchw(z))
    tin = _nchw(x).reshape(1, 2, 3, 32, 32) if dims == 3 else _nchw(x)
    got, glog = tl.generator_loss(tin, rec, regularization_log={"kl_loss": torch.tensor(kl)},
                                  global_step=1, train=True,
                                  last_layer=list(tdec.conv_out.parameters()))
    assert set(glog) == set(wlog)
    for k in wlog:
        _close(glog[k], wlog[k], msg=k)
    _close(got, want)
    d_weight = float(wlog["train/scalars/d_weight"])
    assert d_weight == 0.0 if case == "gated" else 0.0 < d_weight < 0.7e4

    rec_np = rec.detach().permute(0, 2, 3, 1).numpy()
    want_d, dlog, stats = jl.discriminator_loss(state, xin, rec_np, global_step=1, train=True)
    got_d, tlog = tl.discriminator_loss(tin, rec.detach(), global_step=1, train=True)
    _close(got_d, want_d)
    assert (float(want_d) == 0.0) == (case == "gated")
    for k in dlog:
        _close(tlog[k], dlog[k], msg=k)
    for n, idx in ((1, 3), (2, 6)):
        _close(tl.discriminator.main[idx].running_mean, stats[f"norm{n}"]["mean"])
        _close(tl.discriminator.main[idx].running_var, stats[f"norm{n}"]["var"])


def test_latent_lpips_matches_jax(lpips_pair):
    """Latent L2 + LPIPS of the decoded latents + LPIPS against 16² inputs
    resized (cubic, antialiased, as jax.image.resize) to the 32² decode."""
    from hi3d_tpu.models.discriminator import LatentLPIPS as JaxLatentLPIPS
    from hi3d_tpu_torch.models.discriminator import LatentLPIPS

    cfg = {"decoder_config": {"target": "sgm.models.autoencoder.AutoencoderKL",
                              "params": {"ddconfig": DD}},
           "perceptual_weight": 1.0, "latent_weight": 0.5, "perceptual_weight_on_inputs": 0.3,
           "scale_input_to_tgt_size": True}
    jl = JaxLatentLPIPS(**cfg)
    jl.lpips_params = lpips_pair[1]
    x = np.zeros((1, 32, 32, 3), np.float32)
    jl.decoder.params = _randomize(jax.eval_shape(jl.decoder.module.init,
                                                  jax.random.PRNGKey(0), x), 10)
    tl = LatentLPIPS(**cfg)
    load_flax_tree(tl.decoder, _np(jl.decoder.params))
    load_flax_tree(tl.perceptual_loss, _np(jl.lpips_params), lpips_flax_name)
    rnd = np.random.RandomState(11)
    z1 = rnd.randn(2, 16, 16, 4).astype(np.float32)
    z2 = (z1 + 0.3 * rnd.randn(*z1.shape)).astype(np.float32)
    img = np.tanh(rnd.randn(2, 16, 16, 3)).astype(np.float32)
    want, wlog = jax.jit(jl)(z1, z2, img)
    with torch.no_grad():
        got, glog = tl(_nchw(z1), _nchw(z2), _nchw(img))
    assert set(glog) == set(wlog)
    for k in wlog:
        _close(glog[k], wlog[k], msg=k)
    _close(got, want)


def test_vector_quantizer_matches_jax(tmp_path):
    """Codes, indices, the β loss, perplexity and cluster use, the
    straight-through gradient and the codebook lookup; then with a 'extra'
    remap table."""
    from hi3d_tpu.models.quantizers import VectorQuantizer as JaxVQ
    from hi3d_tpu_torch.models.quantizers import VectorQuantizer

    rnd = np.random.RandomState(12)
    z = (0.05 * rnd.randn(2, 4, 4, 4)).astype(np.float32)
    codebook = rnd.uniform(-1 / 16, 1 / 16, (16, 4)).astype(np.float32)
    used = tmp_path / "used.npy"
    np.save(used, np.array([1, 3, 4, 7, 9, 12]))
    for kw in ({"sane_index_shape": True, "log_perplexity": True},
               {"remap": str(used), "unknown_index": "extra"}):
        jq, tq = JaxVQ(16, 4, beta=0.25, **kw), VectorQuantizer(16, 4, beta=0.25, **kw)
        jq.embedding = jnp.asarray(codebook)
        load_flax_tree(tq, {"embedding": {"embedding": codebook}})
        want, wlog = jax.jit(jq.__call__)(jnp.asarray(z))
        zt = _nchw(z).requires_grad_()
        got, glog = tq(zt)
        _close(_nhwc(got), want)
        for k in wlog:
            if k == "min_encoding_indices":
                np.testing.assert_array_equal(glog[k].numpy(), np.asarray(wlog[k]))
            else:
                _close(glog[k], wlog[k], msg=k)
        got.sum().backward()
        assert torch.equal(zt.grad, torch.ones_like(zt))
        idx = glog["min_encoding_indices"].reshape(-1)
        back = tq.get_codebook_entry(idx, shape=(2, 4, 4, 4))
        _close(_nhwc(back), jq.get_codebook_entry(jnp.asarray(idx.numpy()), shape=(2, 4, 4, 4)))


def test_gumbel_quantizer_matches_jax():
    """The draw-free parts: the logits, the KL to the uniform prior, the
    codebook lookup; the eval-mode output (always hard) is codebook rows."""
    from hi3d_tpu.models.quantizers import GumbelQuantizer as JaxGumbel
    from hi3d_tpu_torch.models.quantizers import GumbelQuantizer

    rnd = np.random.RandomState(13)
    z = rnd.randn(2, 5, 5, 6).astype(np.float32)
    jq, tq = JaxGumbel(6, 4, 10), GumbelQuantizer(6, 4, 10)
    kernel, bias, embed = (rnd.randn(6, 10) / 3, 0.1 * rnd.randn(10), rnd.randn(10, 4))
    jq.proj_kernel, jq.proj_bias, jq.embed = (jnp.asarray(v, jnp.float32)
                                              for v in (kernel, bias, embed))
    load_flax_tree(tq, {"proj": {"kernel": kernel[None, None].astype(np.float32),
                                 "bias": bias.astype(np.float32)},
                        "embed": {"embedding": embed.astype(np.float32)}})
    _, wlog = jax.jit(functools.partial(jq.__call__, rng=jax.random.PRNGKey(0),
                                        return_logits=True))(jnp.asarray(z))
    with torch.no_grad():
        _, glog = tq(_nchw(z), torch.Generator().manual_seed(0), return_logits=True)
        hard, hlog = tq(_nchw(z), torch.Generator().manual_seed(1), train=False)
    _close(_nhwc(glog["logits"]), wlog["logits"])
    _close(glog["loss/vq"], wlog["loss/vq"])
    rows = _nhwc(hard).reshape(-1, 4)
    np.testing.assert_allclose(rows, embed.astype(np.float32)[hlog["indices"].reshape(-1)],
                               atol=1e-6)
    idx = hlog["indices"]
    _close(_nhwc(tq.get_codebook_entry(idx, (2, 5, 5, 4))),
           jq.get_codebook_entry(jnp.asarray(idx.numpy()), (2, 5, 5, 4)))


def test_ema_quantizer_update_matches_jax():
    """One training call: codes, loss and perplexity from the old codebook,
    then the EMA step of cluster_size, embed_avg and the codebook; an eval
    call changes nothing."""
    from hi3d_tpu.models.quantizers import EMAVectorQuantizer as JaxEMA
    from hi3d_tpu_torch.models.quantizers import EMAVectorQuantizer

    rnd = np.random.RandomState(14)
    z = rnd.randn(2, 3, 3, 3).astype(np.float32)
    w = rnd.randn(6, 3).astype(np.float32)
    jq, tq = JaxEMA(6, 3, beta=0.5, decay=0.9), EMAVectorQuantizer(6, 3, beta=0.5, decay=0.9)
    jq.init_params(jax.random.PRNGKey(0))
    jq.weight, jq.embed_avg = jnp.asarray(w), jnp.asarray(w)
    load_flax_tree(tq, {"embedding": {"weight": w, "cluster_size": np.zeros(6, np.float32),
                                      "embed_avg": w}})
    want, wlog = jax.jit(functools.partial(jq.__call__, train=True))(jnp.asarray(z))
    jq.apply_updates(*wlog["ema_updates"])  # under jit the JAX quantizer returns its step
    with torch.no_grad():
        got, glog = tq(_nchw(z), train=True)
    _close(_nhwc(got), want)
    for k in ("loss/vq", "perplexity", "encodings"):
        _close(glog[k], wlog[k], msg=k)
    for name, jv in (("cluster_size", jq.cluster_size), ("embed_avg", jq.embed_avg),
                     ("weight", jq.weight)):
        _close(getattr(tq.embedding, name), jv, msg=name)
    before = tq.embedding.weight.clone()
    tq(_nchw(z), train=False)
    assert torch.equal(tq.embedding.weight, before)


def test_vq_with_input_projection_matches_jax():
    from hi3d_tpu.models.quantizers import VectorQuantizerWithInputProjection as JaxVQP
    from hi3d_tpu_torch.models.quantizers import VectorQuantizerWithInputProjection

    rnd = np.random.RandomState(15)
    z = rnd.randn(2, 3, 3, 6).astype(np.float32)
    jq, tq = JaxVQP(6, 12, 4, output_dim=6), VectorQuantizerWithInputProjection(6, 12, 4,
                                                                                 output_dim=6)
    p = {"embedding": rnd.randn(12, 4), "proj_in_kernel": rnd.randn(6, 4) / 2,
         "proj_in_bias": 0.1 * rnd.randn(4), "proj_out_kernel": rnd.randn(4, 6) / 2,
         "proj_out_bias": 0.1 * rnd.randn(6)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    for k, v in p.items():
        setattr(jq, k, jnp.asarray(v))
    load_flax_tree(tq, {"embedding": {"embedding": p["embedding"]},
                        "proj_in": {"kernel": p["proj_in_kernel"], "bias": p["proj_in_bias"]},
                        "proj_out": {"kernel": p["proj_out_kernel"],
                                     "bias": p["proj_out_bias"]}})
    want, wlog = jax.jit(jq.__call__)(jnp.asarray(z))
    with torch.no_grad():
        got, glog = tq(_nchw(z))
    assert got.shape == (2, 6, 3, 3)
    _close(_nhwc(got), want)
    _close(glog["loss/vq"], wlog["loss/vq"])


def _engine_config():
    return {
        "encoder_config": {"target": "sgm.modules.diffusionmodules.model.Encoder", "params": DD},
        "decoder_config": {"target": "sgm.modules.diffusionmodules.model.Decoder", "params": DD},
        "regularizer_config": {
            "target": "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer",
            "params": {"sample": False}},
    }


def test_autoencoder_trainer_two_steps_match_jax():
    """A generator step then a discriminator step from the same weights and
    batch (perceptual weight 0, as tests/test_ae_trainer.py) at the default
    lr: the losses and every log value (d_weight too), the step count,
    Adam's first moments (gradients, held at 1e-4 of the module's largest)
    and the updated encoder, decoder and discriminator. Adam's first step
    moves a weight by lr·g/(|g| + 1e-8), ±lr wherever |g| ≫ 1e-8, so the
    updates are held at 1 % of lr where |g| is above 1e-3 of the largest:
    below that a gradient can be roundoff (a bias under a one-channel
    GroupNorm), whose sign is random in either package."""
    from hi3d_tpu.models.autoencoding import AutoencodingEngine as JaxEngine
    from hi3d_tpu.models.discriminator import GeneralLPIPSWithDiscriminator as JaxLoss
    from hi3d_tpu.training.ae_step import AutoencoderTrainer as JaxTrainer
    from hi3d_tpu_torch.models.autoencoding import AutoencodingEngine
    from hi3d_tpu_torch.models.discriminator import GeneralLPIPSWithDiscriminator
    from hi3d_tpu_torch.training.ae_step import AutoencoderTrainer

    lr = 4.5e-6
    loss_kw = dict(disc_start=0, perceptual_weight=0.0, disc_weight=0.5, disc_num_layers=2)
    jt = JaxTrainer(JaxEngine(**_engine_config()), JaxLoss(**loss_kw), lr=lr)
    key, x0 = jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32)
    enc = jax.eval_shape(jt.engine.encoder.init, key, x0)["params"]
    dec = jax.eval_shape(jt.engine.decoder.init, key, np.zeros((1, 16, 16, 4), np.float32))
    disc = jax.eval_shape(functools.partial(jt.loss.discriminator.init, train=True), key, x0)
    ae = {"encoder": _randomize(enc, 17), "decoder": _randomize(dec["params"], 18),
          "logvar": jnp.float32(0.0)}
    disc = {"params": _randomize(disc["params"], 19), "batch_stats": _bn_stats(disc["batch_stats"], 20)}
    state = {"ae": {"params": ae, "opt": jt.opt_ae.init(ae)},
             "disc": {"vars": disc, "opt": jt.opt_disc.init(disc["params"])},
             "lpips": None, "step": jnp.zeros((), jnp.int32)}
    start = _np(state)
    tt = AutoencoderTrainer(AutoencodingEngine(**_engine_config()),
                            GeneralLPIPSWithDiscriminator(**loss_kw), lr=lr, device="cpu")
    load_flax_tree(tt.engine.encoder, start["ae"]["params"]["encoder"])
    load_flax_tree(tt.engine.decoder, start["ae"]["params"]["decoder"])
    load_flax_tree(tt.loss.discriminator, start["disc"]["vars"], discriminator_flax_name(2))
    trained = (tt.engine.encoder, tt.engine.decoder, tt.loss.discriminator)
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in trained]

    x = (0.3 * np.random.RandomState(16).randn(2, 32, 32, 3)).astype(np.float32)
    losses = []
    for batch_idx in (0, 1):
        state, want, wlog = jt.train_step(state, jnp.asarray(x), batch_idx,
                                          jax.random.PRNGKey(batch_idx))
        got, glog = tt.train_step(_nchw(x), batch_idx)
        losses.append((float(got), float(want)))
        _close(got, want)
        for k in wlog:
            _close(glog[k], wlog[k], rtol=1e-4, atol=1e-5, msg=k)
    assert int(state["step"]) == tt.global_step == 2
    assert float(wlog["train/loss/disc"]) > 0
    end = _np(state)
    mu_ae, mu_disc = end["ae"]["opt"][0].mu, end["disc"]["opt"][0].mu
    jax_side = ((end["ae"]["params"]["encoder"], mu_ae["encoder"], flax_module_name),
                (end["ae"]["params"]["decoder"], mu_ae["decoder"], flax_module_name),
                (end["disc"]["vars"],
                 {"params": mu_disc, "batch_stats": end["disc"]["vars"]["batch_stats"]},
                 discriminator_flax_name(2)))
    for module, opt, old, (tree, mu, name_of) in zip(trained, (tt.opt_ae, tt.opt_ae, tt.opt_disc),
                                                     before, jax_side):
        params = dict(module.named_parameters())
        got = {k: v.clone() for k, v in module.state_dict().items()}
        got_mu = {k: opt.state[p]["exp_avg"].clone() for k, p in params.items()}
        load_flax_tree(module, mu, name_of)  # JAX's first moments, (1 − β1)·gradient
        want_mu = {k: p.detach().clone() for k, p in module.named_parameters()}
        load_flax_tree(module, tree, name_of)  # JAX's updated weights and statistics
        want = module.state_dict()
        scale = max(v.abs().max() for v in want_mu.values())
        for k in got:
            if k.endswith("num_batches_tracked"):
                continue
            if k not in params:  # running statistics
                _close(got[k], want[k], msg=k)
                continue
            _close(got_mu[k], want_mu[k], rtol=0, atol=1e-4 * scale, msg=f"{k} moment")
            live = want_mu[k].abs() > 1e-3 * scale
            assert live.any() or want_mu[k].abs().max() < 1e-3 * scale
            _close((got[k] - old[k])[live], (want[k] - old[k])[live], rtol=0, atol=1e-2 * lr,
                   msg=k)
