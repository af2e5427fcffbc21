"""The training CLI's media and export surface: hi3d_tpu_torch against
hi3d_tpu on the CPU, fp32.

- `log_images` (stage 1 and stage 2) and `log_conditionings` on the tiny
  engines of tests/test_torch_slice.py and tests/test_torch_stage2.py with
  2 sampler steps, one set of weights on both sides; the cond-frame noise
  and the sampler's initial noise are pinned on both sides (numpy draws
  written into the batch and handed to `sample` as `randn`).
- The caption images: the port's bitmap font is not PIL's, so shape, range,
  wrapping and the rows each line's ink falls on are held.
- The image logger's files, the post-train test pass, a dump leaving the
  training trajectory bit-equal, `--outckpt`, the metrics backends and the
  metrics cadence.

Tolerances (XLA against ATen summation orders, as tests/test_torch_slice.py
states): `inputs` exact; the fp32 VAE's
`reconstructions` 1e-4 absolute; `samples` and `cond-video` 2e-3 absolute
(the latents sit at σ_max = 700 scale through the first steps); the DPT's
`depth-video` 2e-3 absolute after its min-max normalisation; caption ink
rows within max(1, size // 25) rows of PIL's.
"""

import inspect
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import yaml

from test_torch_slice import RES, T, _randomize_zeros, tiny_config
from test_torch_stage2 import _to_jax_dpt, tiny_stage2_config

STEPS = 2
SAMPLE_ATOL = 2e-3
RECON_ATOL = 1e-4


def _stage1_engines():
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu.convert.jax_to_torch import _export_tree, export_engine_state_dict, vae_path_to_torch
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_vae_key, load_engine_params
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.convert import load_reference_state_dict

    jm = jax_instantiate(tiny_config("test_torch_slice.TinyImageEmbedderJax", num_steps=STEPS))
    jm.init(latent_hw=(RES // 8, RES // 8), num_frames=2)
    sd = _randomize_zeros(export_engine_state_dict(jm), 0)
    load_engine_params(jm, sd)
    jenc = jm.conditioner.embedders[2].encoder
    enc_sd = _randomize_zeros(_export_tree(jenc.params, vae_path_to_torch, ""), 1)
    jenc.params = convert_state_dict(enc_sd, convert_vae_key)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = instantiate_from_config(tiny_config("test_torch_slice.TinyImageEmbedderTorch",
                                                 num_steps=STEPS))
    tm.init_from_ckpt(sd)
    load_reference_state_dict(tm.conditioner.embedders[2].encoder, enc_sd)
    return jm, tm


@pytest.fixture(scope="module")
def stage1():
    return _stage1_engines()


@pytest.fixture(scope="module")
def stage2():
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu.convert.jax_to_torch import export_engine_state_dict
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_vae_key, load_engine_params
    from hi3d_tpu_torch.config import instantiate_from_config

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HI3D_ZERO_INIT", "1")
        jm = jax_instantiate(tiny_stage2_config("test_torch_slice.TinyImageEmbedderJax",
                                                num_steps=STEPS))
    jm.init(latent_hw=(RES // 8, RES // 8), num_frames=2)
    sd = _randomize_zeros(export_engine_state_dict(jm), 0)
    load_engine_params(jm, sd)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = instantiate_from_config(tiny_stage2_config("test_torch_slice.TinyImageEmbedderTorch",
                                                        num_steps=STEPS))
    tm.init_from_ckpt(sd)
    jemb, temb = jm.conditioner.embedders, tm.conditioner.embedders
    jemb[2].params = _to_jax_dpt(temb[2].model)
    jemb[3].encoder.params = convert_state_dict(
        {k: v.numpy() for k, v in temb[3].encoder.state_dict().items()}, convert_vae_key)
    return jm, tm


def _pin(monkeypatch, jm, tm, cond_frames, noise):
    """Both engines' add_custom_cond give `cond_frames` (JAX layout) and
    their `sample` starts from `noise`."""
    j_acc, t_acc, j_sample, t_sample = (jm.add_custom_cond, tm.add_custom_cond, jm.sample,
                                        tm.sample)
    nchw = torch.from_numpy(np.ascontiguousarray(np.moveaxis(cond_frames, -1, 1)))

    def jax_acc(batch, infer=False, rng=None):
        return {**j_acc(batch, infer=infer, rng=rng), "cond_frames": jnp.asarray(cond_frames)}

    def port_acc(batch, infer=False, generator=None):
        return {**t_acc(batch, infer=infer, generator=generator), "cond_frames": nchw}

    monkeypatch.setattr(jm, "add_custom_cond", jax_acc)
    monkeypatch.setattr(tm, "add_custom_cond", port_acc)
    monkeypatch.setattr(jm, "sample", lambda **kw: j_sample(**kw, randn=jnp.asarray(noise)))
    monkeypatch.setattr(tm, "sample", lambda **kw: t_sample(**kw, randn=noise))


def _video_batch(video, caption=None):
    """(JAX batch, port batch) of a (B, T, H, W, 3) clip at elevation 10."""
    jb = {"video": jnp.asarray(video), "elevation": jnp.full((len(video),), 10.0)}
    tb = {"video": torch.from_numpy(video).permute(0, 1, 4, 2, 3),
          "elevation": torch.full((len(video),), 10.0)}
    if caption is not None:
        jb["caption"] = tb["caption"] = caption
    return jb, tb


def _check_media(got, want, keys):
    assert set(got) == set(want) == set(keys)
    for k in keys:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        assert np.isfinite(got[k]).all(), k
    np.testing.assert_array_equal(got["inputs"], want["inputs"])
    np.testing.assert_allclose(got["reconstructions"], want["reconstructions"], atol=RECON_ATOL,
                               rtol=0)
    assert np.abs(want["samples"]).max() > 0.05  # not two blank videos
    np.testing.assert_allclose(got["samples"], want["samples"], atol=SAMPLE_ATOL, rtol=0)


def test_log_images_matches_jax(stage1, monkeypatch):
    """Stage 1 on the first of a batch of two videos with captions: the JAX
    engine conditions on the whole batch and fails there (its sampler mixes
    two videos' conditioning into one video's latents), so the port cuts the
    batch first and is held against JAX on the first video alone."""
    jm, tm = stage1
    videos = 2
    rnd = np.random.RandomState(videos)
    video = (rnd.rand(videos, T, RES, RES, 3) * 2 - 1).astype(np.float32)
    cond_frames = (video[:1, 0] + np.float32(0.02) * rnd.randn(1, RES, RES, 3)).astype(np.float32)
    noise = rnd.randn(T, RES // 8, RES // 8, 4).astype(np.float32)
    captions = [f"obj{i}_000.png" for i in range(videos)]
    jb, tb = _video_batch(video, captions)
    with pytest.raises(TypeError, match="concatenate"):
        jm.log_images(jb, n=1, rng=jax.random.PRNGKey(0))
    jb, _ = _video_batch(video[:1], captions[:1])
    _pin(monkeypatch, jm, tm, cond_frames, noise)
    want = jm.log_images(jb, n=1, rng=jax.random.PRNGKey(0))
    got = tm.log_images(tb, n=1)
    _check_media(got, want, ("inputs", "reconstructions", "samples", "conditioning"))
    assert got["inputs"].shape == (1, T, RES, RES, 3)
    assert got["conditioning"].shape == (1, 512, 512, 3)
    _same_lines(got["conditioning"], want["conditioning"], 16)
    assert tm.training is False and torch.is_grad_enabled()
    assert not any(m.training for m in tm.modules())


def test_log_images_keeps_training_mode_and_draws(stage1):
    """log_images puts each module's training flag back, leaves the global
    RNG alone, and without a caption or with `no_cond_log` writes no
    `conditioning`."""
    _, tm = stage1
    video = (np.random.RandomState(7).rand(1, T, RES, RES, 3) * 2 - 1).astype(np.float32)
    _, tb = _video_batch(video)
    tm.model.diffusion_model.train()
    try:
        state = torch.random.get_rng_state()
        log = tm.log_images(tb, n=1, sample=False)
        assert torch.equal(state, torch.random.get_rng_state())
        assert tm.model.diffusion_model.training and not tm.first_stage_model.training
    finally:
        tm.eval()
    assert set(log) == {"inputs", "reconstructions"}
    tm.no_cond_log = True
    try:
        assert "conditioning" not in tm.log_images({**tb, "caption": ["x"]}, n=1, sample=False)
    finally:
        tm.no_cond_log = False


def test_stage2_log_images_matches_jax(stage2, monkeypatch):
    """Stage 2 adds `depth-video`, the port's own DepthEmbedder unshuffle
    inverted, and `cond-video`, the raw conditioning latents decoded. JAX
    runs without its sampler here (the sampling code is stage 1's, held
    above); the port's run with it adds `samples` of the clip's shape."""
    jm, tm = stage2
    rnd = np.random.RandomState(3)
    video = (rnd.rand(1, T, RES, RES, 3) * 2 - 1).astype(np.float32)
    cond_frames = (video[0] + np.float32(0.02) * rnd.randn(T, RES, RES, 3)).astype(np.float32)
    noise = rnd.randn(T, RES // 8, RES // 8, 4).astype(np.float32)
    jb, tb = _video_batch(video, "obj0")
    _pin(monkeypatch, jm, tm, cond_frames, noise)
    want = jm.log_images(jb, n=1, sample=False, rng=jax.random.PRNGKey(0))
    got = tm.log_images(tb, n=1)
    assert set(got) == set(want) | {"samples"}
    assert set(want) == {"inputs", "reconstructions", "conditioning", "depth-video", "cond-video"}
    for k in got:
        assert got[k].dtype == np.float32 and np.isfinite(got[k]).all(), k
        assert got[k].shape == (want[k] if k != "samples" else want["inputs"]).shape, k
    np.testing.assert_array_equal(got["inputs"], want["inputs"])
    np.testing.assert_allclose(got["reconstructions"], want["reconstructions"], atol=RECON_ATOL,
                               rtol=0)
    _same_lines(got["conditioning"], want["conditioning"], 16)
    h = RES // 8 * 3
    assert got["depth-video"].shape == (1, T, h, h, 3)
    assert -1.0 <= got["depth-video"].min() and got["depth-video"].max() <= 1.0
    np.testing.assert_allclose(got["depth-video"], want["depth-video"], atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(got["cond-video"], want["cond-video"], atol=SAMPLE_ATOL, rtol=0)


def test_log_conditionings_matches_jax(stage1):
    jm, tm = stage1
    video = np.zeros((2, T, RES, RES, 3), np.float32)
    jb, tb = _video_batch(video)
    jb["elevation"] = jnp.asarray([0.0, 10.0])
    tb["elevation"] = torch.tensor([0.0, 10.0])
    want, got = jm.log_conditionings(jb, n=2), tm.log_conditionings(tb, n=2)
    assert set(got) == set(want) == {"elevation"}
    assert got["elevation"].shape == want["elevation"].shape == (2, RES, RES, 3)
    _same_lines(got["elevation"], want["elevation"], RES // 4)
    tm.no_cond_log = True
    try:
        assert tm.log_conditionings(tb, n=2) == {}
    finally:
        tm.no_cond_log = False


def _line_rows(img, size):
    """(first, last) ink row (< 0) of each line above its baseline: line k
    fills rows [k·pitch, k·pitch + ascent) of the image, Pillow's multiline
    layout (pitch = the ascent + 4)."""
    from hi3d_tpu_torch.utils.font import line_metrics

    pitch, ascent = line_metrics(size)[:2]
    rows = (img < 0).any(axis=(1, 2))
    out = []
    for top in range(0, len(rows), pitch):
        ink = np.flatnonzero(rows[top:top + ascent])
        if len(ink):
            out.append((top + ink[0], top + ink[-1]))
    return out


@pytest.mark.parametrize("wh,size", [((512, 512), 16), ((512, 512), 25), ((256, 256), 12),
                                     ((64, 64), 16), ((1024, 256), 51)])
def test_log_txt_as_img_lines_match_jax(wh, size):
    from hi3d_tpu.utils.image import log_txt_as_img as jax_txt
    from hi3d_tpu_torch.utils.image import log_txt_as_img

    caps = ["obj0_000.png is a long caption that wraps onto more lines than one: 42 gjpqy!",
            ["a list caption takes its first element", "not this one"], "Hi3D"]
    want, got = jax_txt(wh, caps, size=size), log_txt_as_img(wh, caps, size=size)
    assert got.shape == want.shape == (3, wh[1], wh[0], 3) and got.dtype == np.float32
    assert set(np.unique(got)) == {-1.0, 1.0}  # black text on white
    assert np.all(got == got[..., :1])
    _same_lines(got, want, size)


def _same_lines(got, want, size):
    """Each caption image has as many lines as PIL's, and each line's ink
    above the baseline starts and ends within max(1, size // 25) rows of
    PIL's."""
    slack = max(1, size // 25)
    for g, w in zip(got, want):
        rows_g, rows_w = _line_rows(g, size), _line_rows(w, size)
        assert len(rows_g) == len(rows_w), (rows_g, rows_w)
        for (g0, g1), (w0, w1) in zip(rows_g, rows_w):
            assert abs(g0 - w0) <= slack and abs(g1 - w1) <= slack, (rows_g, rows_w)


class _Media:
    """A stand-in engine whose log_images returns fixed media."""

    device = torch.device("cpu")

    def __init__(self, media):
        self.media, self.calls = media, []

    def log_images(self, batch, n=1, **kw):
        self.calls.append((batch, n, kw))
        return self.media


def test_image_logger_files_match_jax(tmp_path, capsys):
    """Both loggers on the same media: JAX's `step…_{key}_{i}.mp4` becomes
    the port's directory of that name holding its PNG frames and that mp4
    (padded to whole seconds at 8 fps, as JAX's export pads its mp4; the
    port's decodes to the H.264 reconstruction of the PNGs, as many frames
    as cv2 reads from JAX's), the image entry the same PNG; a failing
    log_images is printed, not raised."""
    from hi3d_tpu.training.trainer import ImageLogger as JaxImageLogger
    from hi3d_tpu_torch.training.trainer import ImageLogger
    from hi3d_tpu_torch.utils.png import read_png

    rnd = np.random.RandomState(0)
    media = {"samples": (rnd.rand(1, 3, 16, 24, 3) * 2.2 - 1.1).astype(np.float32),
             "conditioning": (rnd.rand(1, 16, 24, 3) * 2 - 1).astype(np.float32)}
    ImageLogger(str(tmp_path / "port"), every_n_steps=5).maybe_log(_Media(media), {}, 4)
    assert not (tmp_path / "port").exists()  # not a logging step
    ImageLogger(str(tmp_path / "port"), every_n_steps=5).maybe_log(_Media(media), {}, 10)
    JaxImageLogger(str(tmp_path / "jax"), every_n_steps=5).maybe_log(_Media(media), {}, 10)
    port, ref = tmp_path / "port" / "image_log", tmp_path / "jax" / "image_log"
    assert sorted(os.listdir(ref)) == ["step00000010_conditioning_0.png",
                                       "step00000010_samples_0.mp4"]
    assert sorted(os.listdir(port)) == ["step00000010_conditioning_0.png",
                                        "step00000010_samples_0"]
    import imageio

    np.testing.assert_array_equal(read_png(str(port / "step00000010_conditioning_0.png")),
                                  imageio.imread(ref / "step00000010_conditioning_0.png"))
    frames = port / "step00000010_samples_0" / "frames"
    want = np.round((np.clip(media["samples"][0] * 0.5 + 0.5, 0, 1)) * 255).astype(np.uint8)
    got = np.stack([read_png(str(frames / n)) for n in sorted(os.listdir(frames))])
    assert len(got) == 8  # 3 frames padded with the last to one second at 8 fps
    np.testing.assert_array_equal(got[:3], want)
    np.testing.assert_array_equal(got[3:], np.repeat(want[-1:], 5, axis=0))
    assert sorted(os.listdir(frames.parent)) == ["frames", "step00000010_samples_0.mp4"]
    from hi3d_tpu_torch.utils import h264
    from hi3d_tpu_torch.utils.video import import_video

    video = import_video(str(frames.parent / "step00000010_samples_0.mp4"))
    np.testing.assert_array_equal(video, [h264.to_rgb(*r) for r in h264.encode(got, 5, 8).recon])
    import cv2

    assert cv2.VideoCapture(str(ref / "step00000010_samples_0.mp4")).get(
        cv2.CAP_PROP_FRAME_COUNT) == len(video)

    class Failing:
        device = torch.device("cpu")

        def log_images(self, batch, n=1, **kw):
            return batch["video"]

    capsys.readouterr()
    ImageLogger(str(tmp_path / "p2"), every_n_steps=1).maybe_log(Failing(), {}, 0)
    JaxImageLogger(str(tmp_path / "j2"), every_n_steps=1).maybe_log(Failing(), {}, 0)
    out = capsys.readouterr().out.splitlines()
    assert out == ["[image_log] skipped at step 0: 'video'"] * 2


def _tiny_train_cfg(tmp_path, renders, **lightning):
    from test_torch_training import B, train_config

    model = train_config("test_torch_slice.TinyImageEmbedderTorch")
    model["params"]["ckpt_path"] = str(tmp_path / "missing.safetensors")
    model["params"]["sampler_config"]["params"]["num_steps"] = STEPS
    cfg = {"model": model,
           "data": {"target": "sgm.data.video_dataset.VideoDataset",
                    "params": {"base_folder": renders, "eval_folder": str(tmp_path / "eval"),
                               "width": RES, "height": RES, "sample_frames": T,
                               "batch_size": B, "num_workers": 1}},
           "lightning": lightning}
    path = tmp_path / "tiny-train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _eval_folder(path, seed=0):
    from hi3d_tpu_torch.utils.png import write_png

    os.makedirs(path)
    rgba = np.random.RandomState(seed).randint(0, 256, (37, 29, 4)).astype(np.uint8)
    rgba[:5, :, 3] = 0
    write_png(os.path.join(path, "a.png"), rgba)
    return path


def test_train_cli_test_pass_export_and_logger_as_jax(tmp_path, capsys, stage1):
    """`train.main` with JAX's defaults and `--train False`: the metrics
    cadence, image-logger period and backend come from the config as JAX's
    CLI reads them; the test pass meets what JAX's meets — the eval set's
    first item is one image, not a video batch, so log_images raises
    KeyError('video'), the logger prints it and nothing is written under
    test/ — and `--outckpt` writes the reference layout: the key set and
    values of JAX's `export_engine_state_dict` of the same weights, a file
    that JAX's safetensors package writes the same tensors of and that a
    fresh port engine loads strictly back to the same weights."""
    from hi3d_tpu.convert.jax_to_torch import export_engine_state_dict
    from hi3d_tpu.convert.jax_to_torch import save_safetensors as jax_save
    from hi3d_tpu.data.video_dataset import SyncDreamerEvalData as JaxEval
    from hi3d_tpu.training.trainer import ImageLogger as JaxImageLogger
    from hi3d_tpu.training.trainer import Trainer as JaxTrainer
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.convert import load_checkpoint_file, read_safetensors
    from hi3d_tpu_torch.train import main
    from test_torch_training import _write_renders, train_config

    jm, tm = stage1
    renders = _write_renders(tmp_path / "renders", 1, RES, seed=5)
    _eval_folder(str(tmp_path / "eval"))
    path = _tiny_train_cfg(tmp_path, renders,
                           callbacks={"image_logger": {"params": {"batch_frequency": 7}}},
                           logger="jsonl")
    out_ckpt = str(tmp_path / "export.safetensors")
    capsys.readouterr()
    trainer = main(["--base", str(path), "--device", "cpu", "--train", "False",
                    "--logdir", str(tmp_path / "logs"), "--outckpt", out_ckpt])
    out = capsys.readouterr().out
    assert "[image_log] skipped at step 0: 'video'" in out
    assert f"[train] exported {out_ckpt}" in out
    assert not os.path.exists(os.path.join(trainer.logdir, "test"))
    jax_defaults = inspect.signature(JaxTrainer).parameters
    assert trainer.metrics.log_every == jax_defaults["log_every"].default == 10
    assert trainer.image_logger.every == 7
    assert trainer.metrics._tb is None and trainer.metrics._wandb is None  # lightning.logger: jsonl

    JaxImageLogger(str(tmp_path / "jax_test"), every_n_steps=1).maybe_log(
        jm, next(iter(JaxEval(str(tmp_path / "eval")))), step=0)
    assert capsys.readouterr().out == "[image_log] skipped at step 0: 'video'\n"
    assert not os.path.exists(tmp_path / "jax_test")

    # the export against JAX's of the same weights (the port engine holds them)
    want = export_engine_state_dict(jm)
    got = load_checkpoint_file(out_ckpt)
    model = trainer.engine
    assert set(got) == set(want)
    assert all(k.startswith(("model.diffusion_model.", "first_stage_model.")) for k in got)
    model.init_from_ckpt({k: torch.from_numpy(np.asarray(v)) for k, v in want.items()})
    from hi3d_tpu_torch.convert import export_engine_state_dict as port_export
    from hi3d_tpu_torch.convert import save_safetensors

    sd = port_export(model)
    assert all(v.dtype == torch.float32 for v in sd.values())
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    jax_save(want, str(tmp_path / "jax.safetensors"))
    save_safetensors(sd, str(tmp_path / "port.safetensors"))
    from_jax = read_safetensors(str(tmp_path / "jax.safetensors"))
    assert set(from_jax) == set(sd) and all(torch.equal(from_jax[k], sd[k]) for k in sd)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        fresh = instantiate_from_config(train_config("test_torch_slice.TinyImageEmbedderTorch"))
    fresh.init_from_ckpt(str(tmp_path / "port.safetensors"))  # strict per part
    for a, b in ((fresh.model, model.model), (fresh.first_stage_model, model.first_stage_model)):
        for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(p, q), n


def test_train_cli_without_eval_folder_raises_as_jax(tmp_path):
    """Both training configs name `validation_set_example`, which the
    repository does not hold: the data module's setup raises, as JAX's."""
    from hi3d_tpu.data.video_dataset import VideoDataset as JaxData
    from hi3d_tpu_torch.data.video_dataset import VideoDataset
    from test_torch_training import _write_renders

    renders = _write_renders(tmp_path / "renders", 1, 16, seed=1)
    missing = str(tmp_path / "validation_set_example")
    for cls in (JaxData, VideoDataset):
        with pytest.raises(FileNotFoundError):
            cls(renders, eval_folder=missing, width=16, height=16).setup()
    data = VideoDataset(renders, width=16, height=16)
    assert data.val_dataloader() is None  # no eval_folder: no test pass
    assert JaxData(renders, width=16, height=16).val_dataloader() is None


def test_dump_leaves_training_trajectory_bit_equal(tmp_path):
    """Two tiny steps with EMA, a dump after step 1 in one run and none in
    the other: the same weights, EMA and optimizer state, bit for bit; the
    dump sampled with the EMA weights and wrote its media."""
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.training.trainer import Trainer
    from test_torch_training import _pinned_inputs, _torch_batch, train_config

    inp = _pinned_inputs(2)
    batch = {k: v.numpy() for k, v in _torch_batch(inp).items()
             if k in ("video", "elevation")}
    batch["caption"] = ["obj0_000.png", "obj1_000.png"]
    runs = []
    for every in (1, 10**9):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            cfg = train_config("test_torch_slice.TinyImageEmbedderTorch")
            cfg["params"].update(use_ema=True, trained_param_keys=["diffusion_model.out.",
                                                                   ".time_stack."])
            cfg["params"]["sampler_config"]["params"]["num_steps"] = STEPS
            engine = instantiate_from_config(cfg)
        trainer = Trainer(engine, logdir=str(tmp_path / f"run{every}"), base_lr=1e-3,
                          scale_lr=False, log_images_every=every, logger_backend="jsonl")
        seen = []
        log_images = engine.log_images

        def spy(b, n=1, **kw):  # the dump sees the EMA in the trained parameters
            ts = trainer.train_step
            seen.append(all(torch.equal(p, e) for p, e in zip(ts.params, ts.ema_params)))
            return log_images(b, n=n, **kw)

        engine.log_images = spy
        assert trainer.fit(iter([batch] * 2), max_steps=2, resume=False) == 2
        runs.append((trainer, seen))
    (dumped, seen), (plain, none) = runs
    assert seen == [True, True] and not none
    for a, b in zip(dumped.train_step.params, plain.train_step.params):
        assert torch.equal(a, b)
    for a, b in zip(dumped.train_step.ema_params, plain.train_step.ema_params):
        assert torch.equal(a, b)
    for a, b in zip(dumped.optimizer.state.values(), plain.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(p, e) for p, e in zip(dumped.train_step.params,
                                                     dumped.train_step.ema_params))
    names = sorted(os.listdir(tmp_path / "run1" / "image_log"))
    assert names == [f"step0000000{s}_{k}" for s in (1, 2) for k in (
        "conditioning_0.png", "inputs_0", "reconstructions_0", "samples_0")]


def _event_scalars(tb_dir):
    """{tag: [(step, value)]} of the scalar summaries in a directory of
    TensorBoard event files (TFRecord framing around Event protos)."""
    import struct

    from tensorboard.compat.proto.event_pb2 import Event

    out = {}
    for name in sorted(os.listdir(tb_dir)):
        blob = open(os.path.join(tb_dir, name), "rb").read()
        pos = 0
        while pos < len(blob):
            (n,) = struct.unpack("<Q", blob[pos:pos + 8])
            event = Event.FromString(blob[pos + 12:pos + 12 + n])
            pos += 16 + n
            for v in event.summary.value:
                out.setdefault(v.tag, []).append((event.step, round(v.simple_value, 6)))
    return out


def test_metrics_backends_match_jax(tmp_path, capsys, monkeypatch):
    """tensorboard writes the scalars of every logged step to tb/ event
    files (here with TensorBoard's TF-free stub, as on a host without
    TensorFlow); with its import made to fail, and for wandb (not
    installed), both trainers print the same fallback line and keep
    metrics.jsonl."""
    import types

    from hi3d_tpu.training.trainer import MetricsLogger as JaxMetrics
    from hi3d_tpu_torch.training.trainer import MetricsLogger

    cpu = torch.device("cpu")
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))
    os.makedirs(tmp_path / "tb_run")
    log = MetricsLogger(str(tmp_path / "tb_run"), cpu, log_every=2, backend="tensorboard")
    for step in (1, 2, 3, 4):
        log(step, {"loss": 0.5 / step, "grad_norm": torch.tensor(2.0)})
    log.close()
    rows = [json.loads(x) for x in open(tmp_path / "tb_run" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 4]
    scalars = _event_scalars(tmp_path / "tb_run" / "tb")
    assert {"loss", "grad_norm", "wall_s"} <= set(scalars)
    assert scalars["loss"] == [(2, 0.25), (4, 0.125)]
    assert scalars["grad_norm"] == [(2, 2.0), (4, 2.0)]

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    capsys.readouterr()
    for backend in ("tensorboard", "testtube", "wandb"):
        for i, make in enumerate((lambda d: MetricsLogger(d, cpu, backend=backend),
                                  lambda d: JaxMetrics(d, backend=backend))):
            d = tmp_path / f"{backend}{i}"
            os.makedirs(d)
            m = make(str(d))
            assert m._tb is None and m._wandb is None
            m(10, {"loss": 1.0})
            m.close()
            assert os.path.exists(d / "metrics.jsonl")
        lines = [x for x in capsys.readouterr().out.splitlines() if "unavailable" in x]
        assert len(lines) == 2 and lines[0] == lines[1], lines
