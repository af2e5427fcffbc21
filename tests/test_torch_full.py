"""The two-stage path of the port against hi3d_tpu on CPU, in fp32.

Modules held against the JAX package with the same weights and inputs
(numpy seeds):
- U²-Net (`models/u2net.py`), u2netp and the full variant, one
  upstream-format state dict with random BatchNorm statistics feeding JAX
  through `convert_u2net_sd` and the port through a strict
  `load_state_dict`: `segment` at 64² and the raw side outputs, ≤ 1e-4;
  `preprocess` / `postprocess` (one resize down, one up, antialiased as
  jax.image.resize), ≤ 1e-5; `remove_background` from a saved `u2netp.pth`:
  the alpha PNG within one level of uint8, the white PNG equal; its
  fallback to the input when there is no checkpoint and no `rembg`;
- `AutoencoderKL.decode_tiled` on a tiny VAE (20 × 28 latent, tile 8,
  overlap 2), and the engine's routing to it (`decode_tile_size: 24` on a
  40 × 28 latent, the default overlap of 16), ≤ 1e-4;
- `ViewScorer` with one tiny CLIP tower and MLP: features ≤ 1e-4;
- `TwoStageServer._to_stage2_res` against JAX's cv2.resize, up and down,
  ≤ 1e-5.

The chained path, port only, on the tiny stage-1 and stage-2 configs of
tests/test_torch_slice.py and tests/test_torch_stage2.py: `run_two_stage`
equals i2v → v2v → ViewScorer run by hand with the same seed, writes JAX's
metrics keys, releases a stage it built before building the next, and never
calls a built engine; `TwoStageServer.generate_stream` equals `generate`
batch by batch with each batch's generators, raises a producer's exception
and leaves no producer thread behind.
"""

import gc
import json
import os
import sys
import threading
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_slice import RES, T, VAE_DD, tiny_config
from test_torch_stage2 import tiny_stage2_config

S1 = 32  # stage-1 frames are S1², stage 2 refines them at RES²


# --------------------------------------------------------------------------
# U²-Net
# --------------------------------------------------------------------------


def _u2net_state_dict(full: bool, seed: int = 0):
    """An upstream-layout U²-Net state dict (numpy), random BatchNorm affine
    and running statistics included."""
    from hi3d_tpu_torch.models.u2net import U2Net

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = U2Net(full=full)
    rnd = np.random.RandomState(seed + 1)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.numpy()
        if k.endswith("running_mean"):
            v = (0.3 * rnd.randn(*v.shape)).astype(np.float32)
        elif k.endswith("running_var"):
            v = (np.abs(rnd.randn(*v.shape)) + 0.5).astype(np.float32)
        elif k.endswith("bn_s1.weight"):
            v = (1.0 + 0.2 * rnd.randn(*v.shape)).astype(np.float32)
        elif k.endswith("bn_s1.bias"):
            v = (0.1 * rnd.randn(*v.shape)).astype(np.float32)
        sd[k] = v
    return sd


def _port_u2net(sd, full: bool):
    from hi3d_tpu_torch.models.u2net import U2Net

    model = U2Net(full=full)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("full", [False, True], ids=["u2netp", "u2net"])
def test_u2net_matches_jax(full):
    from hi3d_tpu.convert.torch_to_jax import convert_u2net_sd
    from hi3d_tpu.models.u2net import U2Net as JaxU2Net
    from hi3d_tpu.models.u2net import segment as jax_segment
    from hi3d_tpu_torch.models.u2net import segment

    sd = _u2net_state_dict(full)
    params = convert_u2net_sd(sd)
    model = _port_u2net(sd, full)
    rnd = np.random.RandomState(2)
    img = rnd.randint(0, 256, (97, 131, 3)).astype(np.uint8)
    ref = np.asarray(jax_segment(JaxU2Net(full=full), params, img, size=64))
    out = segment(model, img, size=64).numpy()
    assert out.shape == ref.shape == (97, 131)
    assert out.std() > 0.05  # a mask, not a constant
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)

    x = rnd.randn(1, 64, 64, 3).astype(np.float32)
    jd0, jsides = JaxU2Net(full=full).apply(params, jnp.asarray(x))
    with torch.no_grad():
        d0, sides = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(sides) == len(jsides) == 6
    for got, want in zip([d0] + sides, [jd0] + list(jsides)):
        assert tuple(got.shape) == (1, 1, 64, 64)
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want)[..., 0], atol=1e-4, rtol=0)


def test_u2net_state_dict_keys_are_upstream():
    """The port's names are the ones JAX's converter reads, and every
    converted leaf is a parameter of the JAX model."""
    import flax

    from hi3d_tpu.convert.torch_to_jax import convert_u2net_sd
    from hi3d_tpu.models.u2net import U2Net as JaxU2Net

    sd = _u2net_state_dict(False)
    assert "stage1.rebnconvin.conv_s1.weight" in sd and "stage1d.rebnconv1d.bn_s1.running_var" in sd
    assert "side6.weight" in sd and "outconv.bias" in sd
    flat = flax.traverse_util.flatten_dict(convert_u2net_sd(sd)["params"])
    shapes = jax.eval_shape(lambda: JaxU2Net(full=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    init = flax.traverse_util.flatten_dict(shapes)
    assert set(flat) == set(init)
    assert all(flat[k].shape == init[k].shape for k in flat)


def test_u2net_pre_and_postprocess_match_jax():
    """A 97 × 131 image down to 64² (`preprocess`), a 64² map up to 97 × 131
    and down to 40 × 50 (`postprocess`). Without antialiasing the downscales
    would be off by far more than the tolerance."""
    import torch.nn.functional as F

    from hi3d_tpu.models.u2net import postprocess as jax_post
    from hi3d_tpu.models.u2net import preprocess as jax_pre
    from hi3d_tpu_torch.models.u2net import postprocess, preprocess

    rnd = np.random.RandomState(3)
    img = rnd.randint(0, 256, (97, 131, 3)).astype(np.uint8)
    ref = np.asarray(jax_pre(img, size=64))
    out = preprocess(img, size=64).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    x = torch.from_numpy(img).float().permute(2, 0, 1)[None]
    plain = F.interpolate(x, size=(64, 64), mode="bilinear", align_corners=False) / 255.0
    aa = F.interpolate(x, size=(64, 64), mode="bilinear", align_corners=False,
                       antialias=True) / 255.0
    assert (plain - aa).abs().max().item() > 1e-2

    d0 = rnd.rand(1, 64, 64, 1).astype(np.float32)
    for size in ((97, 131), (40, 50)):
        ref = np.asarray(jax_post(jnp.asarray(d0), size))
        out = postprocess(torch.from_numpy(d0).permute(0, 3, 1, 2), size).numpy()
        assert out.shape == ref.shape == size
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def _demo_like(path, h=90, w=70):
    from hi3d_tpu_torch.utils.png import write_png

    img = np.full((h, w, 3), 255, np.uint8)
    img[20:70, 15:55] = [200, 30, 40]
    img[30:50, 25:45] = [20, 160, 90]
    write_png(str(path), img)
    return str(path)


def test_remove_background_matches_jax(tmp_path, monkeypatch):
    """A random u2netp saved as `u2netp.pth` and named by HI3D_U2NET_CKPT:
    both packages write rgba.png and white.png; the colour channels agree
    exactly, the alpha channel within one level, the white composite
    exactly."""
    from hi3d_tpu.utils.image import remove_background as jax_remove
    from hi3d_tpu_torch.utils.image import remove_background
    from hi3d_tpu_torch.utils.png import read_png

    ckpt = tmp_path / "u2netp.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _u2net_state_dict(False, 4).items()}, ckpt)
    monkeypatch.setenv("HI3D_U2NET_CKPT", str(ckpt))
    src = _demo_like(tmp_path / "in.png")
    outs = {}
    for tag, fn in (("jax", jax_remove), ("port", remove_background)):
        d = tmp_path / tag
        d.mkdir()
        kw = {"device": "cpu"} if tag == "port" else {}
        white = fn(src, str(d / "rgba.png"), str(d / "white.png"), **kw)
        assert white == str(d / "white.png")
        outs[tag] = read_png(str(d / "rgba.png")), read_png(str(d / "white.png"))
    (jrgba, jwhite), (rgba, white) = outs["jax"], outs["port"]
    assert rgba.shape == jrgba.shape == (90, 70, 4) and white.shape == (90, 70, 3)
    np.testing.assert_array_equal(rgba[..., :3], jrgba[..., :3])
    alpha_diff = np.abs(rgba[..., 3].astype(int) - jrgba[..., 3].astype(int))
    assert alpha_diff.max() <= 1
    assert rgba[..., 3].std() > 5  # the mask is not flat
    np.testing.assert_array_equal(white, jwhite)


def test_remove_background_falls_back_to_input(tmp_path, monkeypatch):
    """No checkpoint ($HI3D_U2NET_CKPT unset, no ckpts/ here) and no rembg:
    both packages hand back the input path and write nothing."""
    from hi3d_tpu.utils.image import remove_background as jax_remove
    from hi3d_tpu_torch.utils.image import _u2net_checkpoint, remove_background

    monkeypatch.delenv("HI3D_U2NET_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "rembg", None)
    src = _demo_like(tmp_path / "in.png")
    assert _u2net_checkpoint() is None
    args = (src, str(tmp_path / "rgba.png"), str(tmp_path / "white.png"))
    assert remove_background(*args, device="cpu") == jax_remove(*args) == src
    assert not os.path.exists(args[1]) and not os.path.exists(args[2])


# --------------------------------------------------------------------------
# tiled VAE decode
# --------------------------------------------------------------------------


def _vae_pair():
    """The port's tiny AutoencoderKL and JAX's with the same weights."""
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_vae_key
    from hi3d_tpu.models.vae import AutoencoderKL as JaxVAE
    from hi3d_tpu_torch.models.vae import AutoencoderKL

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = AutoencoderKL(VAE_DD).eval()
    jm = JaxVAE(ddconfig=VAE_DD)
    jm.params = convert_state_dict({k: v.numpy() for k, v in tm.state_dict().items()},
                                   convert_vae_key)
    return jm, tm


def test_decode_tiled_matches_jax():
    """A 20 × 28 latent in 8² tiles overlapping by 2: a 3 × 5 grid whose last
    column is pinned to the edge. Tiling changes the result (the
    decoder sees each tile's border), so the comparison is against JAX's
    tiled decode, not the whole-latent one."""
    jm, tm = _vae_pair()
    z = np.random.RandomState(5).randn(2, 20, 28, 4).astype(np.float32)
    ref = np.asarray(jm.decode_tiled(jnp.asarray(z), tile=8, overlap=2))
    with torch.no_grad():
        out = tm.decode_tiled(torch.from_numpy(z).permute(0, 3, 1, 2), tile=8, overlap=2)
        whole = tm.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    out, whole = (t.permute(0, 2, 3, 1).numpy() for t in (out, whole))
    assert out.shape == ref.shape == (2, 160, 224, 3)
    assert np.abs(out - whole).max() > 1e-3
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_engine_routes_wide_latents_to_tiled_decode(monkeypatch):
    """decode_tile_size 24 on a 40 × 28 latent: both engines decode in tiles
    of 24 with the default overlap of 16 (latents within the tile decode
    whole)."""
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu_torch.config import instantiate_from_config

    jvae, tvae = _vae_pair()
    monkeypatch.setenv("HI3D_ZERO_INIT", "1")
    jm = jax_instantiate(tiny_config("test_torch_slice.TinyImageEmbedderJax"))
    jm.first_stage_model = jvae
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = instantiate_from_config(tiny_config("test_torch_slice.TinyImageEmbedderTorch"))
    tm.first_stage_model = tvae
    jm.decode_tile_size = tm.decode_tile_size = 24
    z = np.random.RandomState(6).randn(2, 40, 28, 4).astype(np.float32)
    ref = np.asarray(jm.decode_first_stage(jnp.asarray(z)))
    out = tm.decode_first_stage(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (2, 320, 224, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    whole = jvae.decode(jnp.asarray(z[:, :24, :24] / jm.scale_factor))
    np.testing.assert_allclose(tm.decode_first_stage(torch.from_numpy(z[:, :24, :24])).numpy(),
                               np.asarray(whole), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# ViewScorer and the stage-2 resize
# --------------------------------------------------------------------------

CLIP_KW = dict(width=32, layers=1, heads=2, patch_size=8, image_size=32, output_dim=16,
               quick_gelu=True)


def _tiny_scorer():
    from hi3d_tpu_torch.models.clip import AestheticMLP, CLIPVisionTransformer
    from hi3d_tpu_torch.pipelines.full import ViewScorer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        clip, mlp = CLIPVisionTransformer(**CLIP_KW), AestheticMLP(16)
    return ViewScorer(clip=clip, mlp=mlp, device="cpu")


def test_view_scorer_matches_jax():
    from hi3d_tpu.conditioners import AestheticMLP as JaxMLP
    from hi3d_tpu.convert.torch_to_jax import (
        convert_aesthetic_mlp,
        convert_clip_visual_key,
        convert_state_dict,
    )
    from hi3d_tpu.models.clip import CLIPVisionTransformer as JaxCLIP
    from hi3d_tpu.pipelines.full import ViewScorer as JaxScorer

    scorer = _tiny_scorer()
    jscorer = JaxScorer(
        clip=JaxCLIP(**CLIP_KW), mlp=JaxMLP(),
        clip_params=convert_state_dict(
            {f"visual.{k}": v.numpy() for k, v in scorer.clip.state_dict().items()},
            convert_clip_visual_key),
        mlp_params=convert_aesthetic_mlp({k: v.numpy() for k, v in scorer.mlp.state_dict().items()}))
    rnd = np.random.RandomState(8)
    ref_img = rnd.randint(0, 256, (40, 48, 3)).astype(np.uint8)
    views = [rnd.randint(0, 256, (40, 48, 3)).astype(np.uint8) for _ in range(3)]
    with torch.no_grad():
        feats = scorer._features(np.stack(views)).numpy()
    np.testing.assert_allclose(feats, np.asarray(jscorer._features(np.stack(views))), atol=1e-4,
                               rtol=0)
    got, want = scorer(ref_img, views), jscorer(ref_img, views)
    assert set(got) == set(want)
    for key in want:  # rounded to 4 decimals on both sides: one unit of the last
        np.testing.assert_allclose(got[key], want[key], atol=1e-4 + 1e-9, rtol=0, err_msg=key)
    assert scorer(ref_img, [ref_img])["clip_similarity"][0] == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("hw", [(64, 64), (20, 24)], ids=["up", "down"])
def test_to_stage2_res_matches_jax_cv2(hw):
    from hi3d_tpu.pipelines.serve import TwoStageServer as JaxServer
    from hi3d_tpu_torch.pipelines.serve import TwoStageServer

    videos = (np.random.RandomState(9).rand(2, 3, 32, 32, 3) * 2 - 1).astype(np.float32)
    ref = JaxServer._to_stage2_res(videos, hw)
    out = TwoStageServer._to_stage2_res(videos, hw, "cpu").numpy()
    assert out.shape == ref.shape == (2, 3, *hw, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    same = TwoStageServer._to_stage2_res(videos, (32, 32), "cpu").numpy()
    np.testing.assert_array_equal(same, videos)


def test_import_video_max_frames(tmp_path):
    from hi3d_tpu_torch.utils.png import write_png
    from hi3d_tpu_torch.utils.video import import_video

    frames = np.random.RandomState(10).randint(0, 256, (5, 8, 6, 3)).astype(np.uint8)
    for i, f in enumerate(frames):
        write_png(str(tmp_path / f"{i:03d}.png"), f)
    np.testing.assert_array_equal(import_video(str(tmp_path), max_frames=3), frames[:3])
    np.testing.assert_array_equal(import_video(str(tmp_path)), frames)
    np.testing.assert_array_equal(import_video(str(tmp_path), max_frames=9), frames)


# --------------------------------------------------------------------------
# the chained path (port only)
# --------------------------------------------------------------------------


def _engine(stage: int):
    from hi3d_tpu_torch.config import instantiate_from_config

    embedder = "test_torch_slice.TinyImageEmbedderTorch"
    cfg = tiny_config(embedder, num_steps=2) if stage == 1 else tiny_stage2_config(embedder,
                                                                                   num_steps=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(stage)
        return instantiate_from_config(cfg).eval()


@pytest.fixture(scope="module")
def engines():
    return _engine(1), _engine(2)


def _frames(out_dir, sub):
    from hi3d_tpu_torch.utils.video import import_video

    return import_video(os.path.join(out_dir, sub, "frames"))


JAX_RESULT_KEYS = {"first_mp4", "second_mp4", "stage1_sec", "stage2_sec", "total_sec", "metrics"}
JAX_METRIC_KEYS = {"clip_similarity", "clip_similarity_mean", "aesthetic", "aesthetic_mean"}


def test_run_two_stage_matches_the_stages_run_by_hand(engines, tmp_path, monkeypatch):
    """Built engines (never called as factories), background removal with a
    u2netp checkpoint: stage 2 reads temp_image/white.png, and the frames
    and scores equal i2v → v2v → ViewScorer run by hand with the same seed."""
    from hi3d_tpu_torch.pipelines import i2v, v2v
    from hi3d_tpu_torch.pipelines.full import run_two_stage
    from hi3d_tpu_torch.utils.image import load_image_rgb
    from hi3d_tpu_torch.utils.video import import_video

    m1, m2 = engines
    calls = []
    hooks = [m.register_forward_pre_hook(lambda *a: calls.append(a)) for m in (m1, m2)]
    ckpt = tmp_path / "u2netp.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _u2net_state_dict(False, 4).items()}, ckpt)
    monkeypatch.setenv("HI3D_U2NET_CKPT", str(ckpt))
    src = _demo_like(tmp_path / "in.png", 48, 40)
    scorer = _tiny_scorer()
    kw = dict(elevation=5.0, clip_size=T, seed=7, fps=8)
    try:
        out_a = str(tmp_path / "a")
        result = run_two_stage(m1, m2, src, out_a, stage1_resolution=(S1, S1),
                               stage2_resolution=(RES, RES), scorer=scorer, **kw)
        out_b = str(tmp_path / "b")
        first = i2v.run_pipeline(m1, src, out_b, resolution=(S1, S1), **kw)
        white = os.path.join(out_b, "temp_image", "white.png")
        second = v2v.run_pipeline(m2, white, first, out_b, resolution=(RES, RES), **kw)
    finally:
        for h in hooks:
            h.remove()
    assert calls == []
    assert os.path.exists(os.path.join(out_a, "temp_image", "rgba.png"))
    assert set(result) == JAX_RESULT_KEYS and set(result["metrics"]) == JAX_METRIC_KEYS
    with open(os.path.join(out_a, "metrics.json")) as f:
        assert json.load(f) == result
    for sub in ("first_step", "second_step_video"):
        np.testing.assert_array_equal(_frames(out_a, sub), _frames(out_b, sub))
    views = import_video(second, max_frames=T)  # the mp4 where a writer imports, as JAX reads
    assert views.shape == (T, RES, RES, 3)
    assert result["metrics"] == scorer(load_image_rgb(white), list(views))
    assert len(result["metrics"]["clip_similarity"]) == T


def test_run_two_stage_releases_a_stage_it_built(tmp_path, monkeypatch):
    """Factories: stage 1 is garbage by the time the stage-2 factory runs;
    without a background-removal model stage 2 reads the input image."""
    from hi3d_tpu_torch.pipelines.full import run_two_stage

    monkeypatch.delenv("HI3D_U2NET_CKPT", raising=False)
    monkeypatch.setitem(sys.modules, "rembg", None)
    built = {}

    def stage1():
        built["m1"] = m = _engine(1)
        built["ref1"] = weakref.ref(m)
        del built["m1"]
        return m

    def stage2():
        gc.collect()
        built["alive_at_stage2"] = built["ref1"]() is not None
        return _engine(2)

    src = _demo_like(tmp_path / "in.png", 40, 40)
    monkeypatch.chdir(tmp_path)  # no ckpts/ here
    result = run_two_stage(stage1, stage2, src, str(tmp_path / "o"), clip_size=T,
                           stage1_resolution=(S1, S1), stage2_resolution=(RES, RES), seed=1,
                           score_views=False)
    assert built["alive_at_stage2"] is False
    assert set(result) == JAX_RESULT_KEYS - {"metrics"}
    assert not os.path.exists(tmp_path / "o" / "temp_image" / "white.png")
    assert _frames(str(tmp_path / "o"), "second_step_video").shape[1:] == (RES, RES, 3)


def test_full_main_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    from hi3d_tpu_torch.pipelines import full

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        full.main(["--image_path", "x.png", "--output_dir", str(tmp_path)])


def _serve_images(n, seed=11):
    rnd = np.random.RandomState(seed)
    return (rnd.rand(n, S1, S1, 3) * 2 - 1).astype(np.float32)


def test_generate_stream_equals_generate_per_batch(engines):
    from hi3d_tpu_torch.pipelines.serve import TwoStageServer

    server = TwoStageServer(*engines)
    batches = [_serve_images(1, 12), _serve_images(1, 13)]
    streamed = list(server.generate_stream(batches, elevations=5.0, seed=3,
                                           stage2_hw=(RES, RES)))
    assert len(streamed) == 2
    for i, (images, got) in enumerate(zip(batches, streamed)):
        want = server.generate(images, elevations=[5.0], generators=server.stage_generators(3, i),
                               stage2_hw=(RES, RES))
        assert got.shape == want.shape == (1, T, RES, RES, 3)
        np.testing.assert_array_equal(got, want)
    assert np.abs(streamed[0] - streamed[1]).max() > 1e-2


def _producer_threads():
    return [t for t in threading.enumerate() if t.name == "serve-stage1-producer" and t.is_alive()]


def test_generate_stream_raises_a_producer_error_and_stops_early(engines):
    from hi3d_tpu_torch.pipelines.serve import TwoStageServer

    server = TwoStageServer(*engines)

    def failing():
        yield _serve_images(1)
        raise RuntimeError("batch source failed")

    stream = server.generate_stream(failing(), stage2_hw=(RES, RES))
    assert next(stream).shape == (1, T, RES, RES, 3)
    with pytest.raises(RuntimeError, match="batch source failed"):
        next(stream)
    with pytest.raises(ValueError, match="per-asset elevations"):
        list(server.generate_stream([_serve_images(2)], elevations=[0.0], stage2_hw=(RES, RES)))

    stream = server.generate_stream([_serve_images(1)] * 3, stage2_hw=(RES, RES))
    next(stream)
    stream.close()  # the consumer stops after one batch
    assert _producer_threads() == []
