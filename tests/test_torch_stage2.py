"""Stage-2 slice parity: hi3d_tpu_torch against hi3d_tpu on CPU, in fp32.

Modules: the port's DPT-hybrid (at the tiny size of
tests/test_pipeline_v2v.py: features 16, ViT width 32, 2 layers, 2 heads,
pos_grid 4; the ResNet-50 backbone keeps its widths) goes into JAX through
hi3d_tpu.convert.torch_to_jax.convert_dpt_key, which must cover the JAX
tower's parameters one to one; its helpers, the #9 GroupNorm module against
JAX's VaeGroupNorm and GroupNormAct, and the DepthEmbedder's packing.

Slice: both packages build the same tiny stage-2 config (the tiny stage-1
layout of tests/test_torch_slice.py with the stage-2 target, 17 input
channels, the DepthEmbedder and the per-frame VAE embedder, one frame per VAE
call), share one set of weights (the JAX UNet and VAE exported into the port,
their zero-initialised leaves randomised; the conditioner's DPT and VAE
encoder carried from the port into JAX), and run the stage-2 conditioning and
`blend_refine_batch` with the same frames, noise and pinned
cond_frames / cond_aug.

Tolerances: both sides are fp32 and differ in summation order (XLA vs ATen)
and in the norms' variance formulas (the port's one-pass moments, flax's
two-pass GroupNorm), ~1e-6 relative per op. The DPT's depth passes ~100 ops
before the min-max normalisation; the blended latents sit at σ_max = 700
scale through the first steps, so the decoded frames agree to 2e-3 absolute,
as in the stage-1 slice test.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_slice import CTX, RES, T, VAE_DD, _randomize_zeros, tiny_config

ATOL = 1e-4
SLICE_ATOL = 2e-3
DPT_KW = {"features": 16, "vit_width": 32, "vit_layers": 2, "vit_heads": 2, "hooks": [0, 1],
          "pos_grid": 4}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _port_dpt(seed=0):
    from hi3d_tpu_torch.models.dpt import DPTDepthModel

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return DPTDepthModel(**DPT_KW).eval()


def _to_jax_dpt(model):
    from hi3d_tpu.convert.torch_to_jax import convert_dpt_key, convert_state_dict

    return convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                              convert_dpt_key)


def test_dpt_state_dict_maps_one_to_one_onto_jax():
    """Every key of the port's DPT has a JAX path under convert_dpt_key
    (only refinenet4.resConfUnit1, unused in both, is dropped), and the
    converted tree has exactly the JAX tower's leaves and shapes."""
    from flax.traverse_util import flatten_dict

    from hi3d_tpu.convert.torch_to_jax import convert_dpt_key
    from hi3d_tpu.models.dpt import DPTDepthModel as JaxDPT

    tm = _port_dpt()
    unmapped = [k for k in tm.state_dict() if convert_dpt_key(k) is None]
    assert all(k.startswith("scratch.refinenet4.resConfUnit1.") for k in unmapped), unmapped
    assert len(unmapped) == 4
    shapes = jax.eval_shape(JaxDPT(**DPT_KW).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    want = {k: v.shape for k, v in flatten_dict(shapes).items()}
    got = {k: v.shape for k, v in flatten_dict(_to_jax_dpt(tm)).items()}
    assert got == want


@pytest.mark.parametrize("hw", [(64, 64), (128, 96)])  # 128×96: position grid resized 4² → 8×6
def test_dpt_matches_jax(hw):
    from hi3d_tpu.models.dpt import DPTDepthModel as JaxDPT

    tm = _port_dpt()
    x = np.random.RandomState(0).rand(2, *hw, 3).astype(np.float32) * 2 - 1
    ref = np.asarray(jax.jit(JaxDPT(**DPT_KW).apply)(_to_jax_dpt(tm), x))
    with torch.no_grad():
        out = tm(_nchw(x)).numpy()
    assert out.shape == ref.shape == (2, *hw)
    assert np.abs(ref).max() > 1e-3  # the ReLU head does not zero everything
    np.testing.assert_allclose(out, ref, atol=ATOL * np.abs(ref).max(), rtol=0)


def test_dpt_helpers_match_jax():
    """align-corners resize (up and down) and the weight-standardised conv
    with TF-"SAME" padding at strides 1 and 2."""
    from hi3d_tpu.models.dpt import StdConv as JaxStdConv
    from hi3d_tpu.models.dpt import resize_bilinear_align_corners as jax_resize
    from hi3d_tpu_torch.models.dpt import StdConv, resize_bilinear_align_corners

    rnd = np.random.RandomState(1)
    x = rnd.randn(2, 10, 14, 5).astype(np.float32)
    for size in ((20, 28), (7, 5)):
        np.testing.assert_allclose(_nhwc(resize_bilinear_align_corners(_nchw(x), size)),
                                   np.asarray(jax_resize(jnp.asarray(x), size)), atol=1e-5)
    for kernel, stride, same in ((7, 2, True), (3, 2, True), (3, 1, True), (1, 2, False)):
        jm = JaxStdConv(6, (kernel, kernel), (stride, stride), use_bias=False,
                        padding="SAME" if same else None)
        tm = StdConv(5, 6, kernel, stride, same=same)
        w = tm.weight.detach().numpy()
        params = {"params": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}}
        ref = np.asarray(jm.apply(params, jnp.asarray(x)))
        out = _nhwc(tm(_nchw(x)))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["vae", "gn_act", "gn"])
def test_folded_group_norm_matches_jax(kind):
    """The #9 GroupNorm module (plain statistics on CPU) against JAX's
    VaeGroupNorm (eps 1e-6) and the DPT's GroupNormAct (eps 1e-5, with and
    without ReLU), forward and — through its autograd Function — backward."""
    from hi3d_tpu.models.dpt import GroupNormAct as JaxGroupNormAct
    from hi3d_tpu.models.vae import VaeGroupNorm
    from hi3d_tpu_torch.models.dpt import GroupNormAct
    from hi3d_tpu_torch.models.layers import FoldedGroupNorm

    rnd = np.random.RandomState(2)
    x = (rnd.randn(2, 6, 5, 64) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rnd.randn(64)).astype(np.float32)
    b = (0.1 * rnd.randn(64)).astype(np.float32)
    cot = rnd.randn(*x.shape).astype(np.float32)
    if kind == "vae":
        jm, tm = VaeGroupNorm(), FoldedGroupNorm(32, 64, eps=1e-6)
    else:
        act = kind == "gn_act"
        jm, tm = JaxGroupNormAct(apply_act=act), GroupNormAct(64, apply_act=act)
    params = {"params": {"norm": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}}

    def loss(x_, p_):
        return jnp.vdot(jm.apply(p_, x_), jnp.asarray(cot))

    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(w))
        tm.bias.copy_(torch.from_numpy(b))
    xt = _nchw(x).requires_grad_()
    out = tm(xt)
    assert out.grad_fn is not None
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)
    out.backward(_nchw(cot))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm.weight.grad.numpy(), np.asarray(gp["params"]["norm"]["scale"]),
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(gp["params"]["norm"]["bias"]),
                               atol=1e-3, rtol=1e-5)


def test_depth_embedder_packing_matches_jax():
    """DepthEmbedder: resize to the DPT's input, depth, resize to (h/8·3),
    per-frame min-max, 3×3 pixel-unshuffle in (row, column) offset order."""
    from hi3d_tpu.conditioners import DepthEmbedder as JaxDepthEmbedder
    from hi3d_tpu_torch.conditioners import DepthEmbedder

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        tm = DepthEmbedder(shuffle_size=3, scale_factor=1.5, model_kwargs=DPT_KW).eval()
    jm = JaxDepthEmbedder(shuffle_size=3, scale_factor=1.5, model_kwargs=DPT_KW)
    jm.params = _to_jax_dpt(tm.model)
    x = np.random.RandomState(4).rand(3, 96, 96, 3).astype(np.float32) * 2 - 1
    ref = np.asarray(jm(jnp.asarray(x)))  # DPT at int(96/1.5/32)·32 = 64²
    with torch.no_grad():
        out = _nhwc(tm(_nchw(x)))
    assert out.shape == ref.shape == (3, 12, 12, 9)
    assert out.min() >= 0.0 and out.max() <= 1.0 and ref.max() > 0.5
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def tiny_stage2_config(embedder_target, num_steps=3):
    """tests/test_pipeline_v2v.py's tiny stage-2 layout on the stage-1 tiny
    config of tests/test_torch_slice.py."""
    cfg = tiny_config(embedder_target, num_steps=num_steps)
    cfg["target"] = "vtdm.vtdm_gen_stage2_degradeImage.VideoLDM"
    p = cfg["params"]
    p["en_and_decode_n_samples_a_time"] = 1
    p["network_config"]["params"]["in_channels"] = 17  # 4 noisy + 9 depth + 4 latent
    p["conditioner_config"]["params"]["emb_models"] = [
        {"target": embedder_target, "input_key": "cond_frames_without_noise",
         "is_trainable": False},
        {"target": "sgm.modules.encoders.modules.ConcatTimestepEmbedderND",
         "input_key": "elevation", "is_trainable": False, "params": {"outdim": 16}},
        {"target": "vtdm.encoders.DepthEmbedder", "input_key": "cond_frames",
         "is_trainable": False,
         "params": {"shuffle_size": 3, "scale_factor": 1.0, "model_kwargs": DPT_KW}},
        {"target": "sgm.modules.encoders.modules.VideoPredictionEmbedderWithEncoder",
         "input_key": "cond_frames", "is_trainable": False,
         "params": {"n_cond_frames": 1, "n_copies": 1, "is_ae": True,
                    "en_and_decode_n_samples_a_time": 1,
                    "encoder_config": {"target": "sgm.models.autoencoder.AutoencoderKLModeOnly",
                                       "params": {"embed_dim": 4, "ddconfig": VAE_DD}}}},
        {"target": "sgm.modules.encoders.modules.ConcatTimestepEmbedderND",
         "input_key": "cond_aug", "is_trainable": False, "params": {"outdim": 16}},
    ]
    return cfg


@pytest.fixture(scope="module")
def models():
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu.convert.jax_to_torch import export_engine_state_dict
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_vae_key, load_engine_params
    from hi3d_tpu_torch.config import instantiate_from_config

    # the JAX conditioner's towers get the port's weights below: build them
    # from shapes only (no initialiser compiled for a 384² DPT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HI3D_ZERO_INIT", "1")
        jm = jax_instantiate(tiny_stage2_config("test_torch_slice.TinyImageEmbedderJax"))
    jm.init(latent_hw=(RES // 8, RES // 8), num_frames=2)
    sd = _randomize_zeros(export_engine_state_dict(jm), 0)
    load_engine_params(jm, sd)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = instantiate_from_config(tiny_stage2_config("test_torch_slice.TinyImageEmbedderTorch"))
    tm.init_from_ckpt(sd)
    jemb, temb = jm.conditioner.embedders, tm.conditioner.embedders
    jemb[2].params = _to_jax_dpt(temb[2].model)
    jemb[3].encoder.params = convert_state_dict(
        {k: v.numpy() for k, v in temb[3].encoder.state_dict().items()}, convert_vae_key)
    return jm, tm


def _inputs(seed):
    rnd = np.random.RandomState(seed)
    video = rnd.rand(1, T, RES, RES, 3).astype(np.float32) * 2 - 1
    noise = rnd.randn(T, RES // 8, RES // 8, 4).astype(np.float32)
    cond_frames = (video[0] + 0.02 * rnd.randn(T, RES, RES, 3)).astype(np.float32)
    aug = np.array([0.02], np.float32)
    jover = {"cond_frames": jnp.asarray(cond_frames), "cond_aug": jnp.asarray(aug)}
    tover = {"cond_frames": _nchw(cond_frames), "cond_aug": torch.from_numpy(aug)}
    return video, noise, jover, tover


def test_stage2_conditioning_matches_jax(models):
    """add_custom_cond (cond_frames = every frame, noise pinned) and the
    paired c/uc: vector = [elevation, cond_aug], crossattn = frame 0,
    concat = [9 depth, 4 latent] channels, both zeroed in uc."""
    from hi3d_tpu.pipelines.i2v import UC_ZERO_KEYS as JAX_UC_ZERO_KEYS
    from hi3d_tpu_torch.pipelines.i2v import UC_ZERO_KEYS

    jm, tm = models
    video, _, jover, tover = _inputs(5)
    jb = jm.add_custom_cond({"video": jnp.asarray(video), "elevation": jnp.asarray([10.0])},
                            infer=True, rng=jax.random.PRNGKey(0))
    tb = tm.add_custom_cond({"video": _nchw(video[0])[None],
                             "elevation": torch.tensor([10.0])}, infer=True)
    assert tuple(tb["cond_frames"].shape) == (T, 3, RES, RES)
    assert tuple(np.asarray(jb["cond_frames"]).shape) == (T, RES, RES, 3)
    np.testing.assert_array_equal(_nhwc(tb["cond_frames_without_noise"]), video[:, 0])
    np.testing.assert_allclose(tb["cond_aug"].numpy(), np.asarray(jb["cond_aug"]))
    # the noise augmentation is applied at inference: cond_frames ≠ video
    noise_std = float((tb["cond_frames"] - _nchw(video[0])).std())
    assert 0.015 < noise_std < 0.025
    jb.update(jover)
    tb.update(tover)
    jc, juc = jm.conditioner.get_unconditional_conditioning(
        jb, force_uc_zero_embeddings=list(JAX_UC_ZERO_KEYS))
    tc, tuc = tm.conditioner.get_unconditional_conditioning(
        tb, force_uc_zero_embeddings=list(UC_ZERO_KEYS))
    for key, perm in (("vector", None), ("crossattn", None), ("concat", _nhwc)):
        for j, t in ((jc, tc), (juc, tuc)):
            got = t[key].numpy() if perm is None else perm(t[key])
            np.testing.assert_allclose(got, np.asarray(j[key]), atol=ATOL, rtol=0, err_msg=key)
    assert tuple(tc["concat"].shape) == (T, 13, RES // 8, RES // 8)
    assert np.abs(tc["concat"][:, :9].numpy()).max() > 0.5  # depth present in c
    assert not tuc["concat"].any() and not tuc["crossattn"].any()


def test_blend_refine_matches_jax(models, monkeypatch):
    from hi3d_tpu.pipelines.v2v import blend_refine_batch as jax_blend
    from hi3d_tpu_torch.pipelines.v2v import blend_refine_batch

    monkeypatch.setenv("HI3D_PROGRAM_CACHE", "0")
    jm, tm = models
    video, noise, jover, tover = _inputs(6)
    ref = jax_blend(jm, video, elevations=[10.0], rng=jax.random.PRNGKey(0),
                    init_noise=jnp.asarray(noise), batch_overrides=jover, steps_per_launch=None)
    out = blend_refine_batch(tm, video, elevations=[10.0], init_noise=noise, batch_overrides=tover)
    assert out.shape == ref.shape == (1, T, RES, RES, 3)
    assert np.all(np.isfinite(out))
    assert np.abs(ref).max() > 0.05  # the comparison is not between two blank videos
    np.testing.assert_allclose(out, ref, atol=SLICE_ATOL, rtol=0)


def test_blend_alpha_matches_jax_schedule():
    from hi3d_tpu_torch.pipelines.v2v import blend_alpha

    i = jnp.arange(25)
    ref = np.asarray((0.5 * (1.0 + jnp.cos(i / 25))) ** 40.0)
    np.testing.assert_allclose([blend_alpha(k, 25) for k in range(25)], ref, rtol=1e-6)
    assert blend_alpha(0, 25) == 1.0


def test_stage2_training_branch_and_wide_decode_raise(models):
    """Stage-2 training is not ported; a latent wider than decode_tile_size
    decodes in tiles (tests/test_torch_full.py), which must exceed the
    default overlap of 16."""
    _, tm = models
    video = torch.zeros((1, T, 3, RES, RES))
    with pytest.raises(NotImplementedError, match="stage-2 training"):
        tm.add_custom_cond({"video": video, "elevation": torch.zeros(1)}, infer=False)
    old = tm.decode_tile_size
    tm.decode_tile_size = 16
    try:
        with pytest.raises(ValueError, match="must exceed its overlap"):
            tm.decode_first_stage(torch.zeros((1, 97, 8, 4)))
    finally:
        tm.decode_tile_size = old


def test_mp4_input_without_reader_raises(tmp_path, monkeypatch):
    """A stage-1 mp4 is read only through imageio or cv2: without either the
    import raises and names the frames directory, never falling back."""
    from hi3d_tpu_torch.utils.video import import_video

    path = tmp_path / "first.mp4"
    path.write_bytes(b"\x00" * 64)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="first_step/frames"):
        import_video(str(path))


def test_v2v_cli_reads_stage1_frames(tmp_path):
    """The port's v2v CLI on CPU at 64²: the tiny stage-2 config, a stage-1
    frames directory (T + 2 PNGs; the last T are used) and a clean image,
    PNG frames written under second_step_video/, phases printed."""
    import yaml

    from hi3d_tpu_torch.utils.png import read_png, write_png
    from hi3d_tpu_torch.utils.video import import_video
    from hi3d_tpu_torch.pipelines.v2v import prepare_inputs

    rnd = np.random.RandomState(7)
    out_dir = tmp_path / "out"
    frame_dir = out_dir / "first_step" / "frames"
    frame_dir.mkdir(parents=True)
    video = rnd.randint(0, 255, (T + 2, 32, 32, 3)).astype(np.uint8)
    for i, f in enumerate(video):
        write_png(str(frame_dir / f"{i:03d}.png"), f)
    img = np.full((32, 32, 3), 255, np.uint8)
    img[8:24, 8:24] = [200, 30, 40]
    write_png(str(tmp_path / "clean.png"), img)
    np.testing.assert_array_equal(import_video(str(frame_dir)), video)
    frames, masks = prepare_inputs(str(tmp_path / "clean.png"), str(frame_dir), T, (RES, RES))
    assert frames.shape == (T, RES, RES, 3) and masks.shape == (T, RES, RES)
    assert masks[0, 32, 32] == 1.0 and masks[0, 2, 2] == 0.0  # frame 0 is the clean image

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(
        {"model": tiny_stage2_config("test_torch_slice.TinyImageEmbedderTorch", num_steps=2)}))
    code = (
        "import sys; sys.path.insert(0, 'tests');"
        "from hi3d_tpu_torch.pipelines.v2v import main;"
        f"main(['--denoise_config', {str(cfg)!r}, '--image_path', {str(tmp_path / 'clean.png')!r},"
        f" '--output_dir', {str(out_dir)!r}, '--device', 'cpu', '--resolution', '64', '64',"
        f" '--clip_size', '{T}', '--seed', '1'])"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    phases = [line for line in res.stdout.splitlines() if line.startswith("[v2v] phases")]
    assert phases and all(k in phases[0] for k in ("conditioner", "dpt", "vae_encode", "sampler"))
    out_frames = out_dir / "second_step_video" / "frames"
    names = sorted(os.listdir(out_frames))
    assert names == [f"{i:03d}.png" for i in range(8)]  # T frames padded to 1 s at fps 8
    got = np.stack([read_png(str(out_frames / n)) for n in names])
    assert got.shape == (8, RES, RES, 3) and got.dtype == np.uint8
    assert (got[T:] == got[T - 1]).all()
