"""The port's batched orbit server (`hi3d_tpu_torch.pipelines.serve`) on CPU.

`OrbitServer.generate` batches several assets into one conditioner pass and
one sampler run; it is held against the JAX package's `generate_orbit` run
per asset on the same tiny stage-1 engines (tests/test_torch_slice.py), with
the same initial noise and conditioning-frame noise handed to both, at a
long clip (40 frames: the port's frame axis on #6's plain version). fp32;
tolerance 2e-3 absolute on the decoded frames, as in test_torch_slice.py.
The CLI runs in orbit mode on a tiny config.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import yaml

from test_torch_slice import models, tiny_config  # noqa: F401  (module fixture)


def test_orbit_server_matches_jax_per_asset(models):  # noqa: F811
    from hi3d_tpu.pipelines.i2v import generate_orbit as jax_generate_orbit
    from hi3d_tpu_torch.pipelines.serve import OrbitServer

    jm, tm = models
    n, t, res = 2, 40, 32
    rnd = np.random.RandomState(9)
    images = rnd.rand(n, res, res, 3).astype(np.float32) * 2.0 - 1.0
    noise = rnd.randn(n * t, res // 8, res // 8, 4).astype(np.float32)
    cond_frames = (images + 0.02 * rnd.randn(n, res, res, 3)).astype(np.float32)
    aug = np.full((n,), 0.02, np.float32)
    elevations = [5.0, -10.0]
    old = jm.num_samples, tm.num_samples
    jm.num_samples = tm.num_samples = t
    try:
        out = OrbitServer(tm).generate(
            images, elevations=elevations, randn=noise,
            batch_overrides={"cond_frames": torch.from_numpy(cond_frames).permute(0, 3, 1, 2),
                             "cond_aug": torch.from_numpy(aug)},
        )
        ref = np.stack([jax_generate_orbit(
            jm, np.repeat(images[a:a + 1], t, axis=0), elevation=elevations[a],
            rng=jax.random.PRNGKey(a), randn=jnp.asarray(noise[a * t:(a + 1) * t]),
            batch_overrides={"cond_frames": jnp.asarray(cond_frames[a:a + 1]),
                             "cond_aug": jnp.asarray(aug[a:a + 1])},
        ) for a in range(n)])
    finally:
        jm.num_samples, tm.num_samples = old
    assert out.shape == ref.shape == (n, t, res, res, 3)
    assert np.abs(ref[1] - ref[0]).max() > 0.05  # the two assets differ
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)


def test_serve_cli_orbit_mode_pads_and_drops(tmp_path):
    """3 PNGs with --batch 2: two batches, the second padded with the last
    image, and only the 3 real assets written, each under its own name."""
    from hi3d_tpu_torch.pipelines import serve
    from hi3d_tpu_torch.utils.png import read_png, write_png

    image_dir = tmp_path / "images"
    image_dir.mkdir()
    rnd = np.random.RandomState(10)
    for name in ("b", "a", "c"):
        write_png(str(image_dir / f"{name}.png"), rnd.randint(0, 256, (40, 48, 3), np.uint8))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"model": tiny_config(
        "test_torch_slice.TinyImageEmbedderTorch", num_steps=2)}))
    out_dir = tmp_path / "out"
    t = 4
    result = serve.main(["--image_dir", str(image_dir), "--output_dir", str(out_dir),
                         "--mode", "orbit", "--batch", "2", "--stage1_config", str(cfg),
                         "--clip_size", str(t), "--resolution", "32", "32", "--seed", "3",
                         "--device", "cpu"])
    assert result["batches"] == 2
    assert len(result["outputs"]) == 3
    assert sorted(os.listdir(out_dir)) == ["a", "b", "c"]
    for name in ("a", "b", "c"):
        frame_dir = out_dir / name / "frames"
        names = sorted(os.listdir(frame_dir))
        assert names == [f"{i:03d}.png" for i in range(8)]  # padded to 1 s at --fps 8
        frames = np.stack([read_png(str(frame_dir / f)) for f in names])
        assert frames.shape == (8, 32, 32, 3) and frames.dtype == np.uint8
        assert (frames[t:] == frames[t - 1]).all()
    assert {"conditioner", "sampler", "vae_decode", "io"} <= set(result["phases"])


def test_unique_names_match_jax():
    from hi3d_tpu.pipelines.serve import _unique_names as jax_unique_names
    from hi3d_tpu_torch.pipelines.serve import _unique_names

    paths = ["d/a.png", "d/a.jpg", "e/a.png", "d/b.png", "d/a_png.webp"]
    assert _unique_names(paths) == jax_unique_names(paths)
    assert len(set(_unique_names(paths))) == len(paths)


def test_serve_two_stage_mode_raises(tmp_path, monkeypatch):
    """--mode two_stage runs on the card by default: without CUDA it raises
    before loading anything, unless --device cpu is passed."""
    from hi3d_tpu_torch.pipelines import serve
    from hi3d_tpu_torch.utils.png import write_png

    write_png(str(tmp_path / "a.png"), np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--image_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                    "--mode", "two_stage"])


def test_serve_cli_two_stage_mode_pads_and_drops(tmp_path):
    """3 PNGs with --batch 2 in two_stage mode on the tiny stage-1 and
    stage-2 configs: two batches handed from stage 1 to stage 2, the second
    padded, only the 3 real assets written, each as refined frames at
    --stage2_resolution."""
    from hi3d_tpu_torch.pipelines import serve
    from hi3d_tpu_torch.utils.png import read_png, write_png
    from test_torch_stage2 import tiny_stage2_config

    image_dir = tmp_path / "images"
    image_dir.mkdir()
    rnd = np.random.RandomState(11)
    for name in ("b", "a", "c"):
        write_png(str(image_dir / f"{name}.png"), rnd.randint(0, 256, (40, 48, 3), np.uint8))
    embedder = "test_torch_slice.TinyImageEmbedderTorch"
    cfg1, cfg2 = tmp_path / "tiny1.yaml", tmp_path / "tiny2.yaml"
    cfg1.write_text(yaml.safe_dump({"model": tiny_config(embedder, num_steps=2)}))
    cfg2.write_text(yaml.safe_dump({"model": tiny_stage2_config(embedder, num_steps=2)}))
    out_dir = tmp_path / "out"
    t = 4
    result = serve.main(["--image_dir", str(image_dir), "--output_dir", str(out_dir),
                         "--mode", "two_stage", "--batch", "2", "--stage1_config", str(cfg1),
                         "--stage2_config", str(cfg2), "--clip_size", str(t),
                         "--resolution", "32", "32", "--stage2_resolution", "64", "48",
                         "--seed", "3", "--device", "cpu"])
    assert result["batches"] == 2
    assert len(result["outputs"]) == 3
    assert sorted(os.listdir(out_dir)) == ["a", "b", "c"]
    for name in ("a", "b", "c"):
        frame_dir = out_dir / name / "frames"
        names = sorted(os.listdir(frame_dir))
        assert names == [f"{i:03d}.png" for i in range(8)]  # padded to 1 s at --fps 8
        frames = np.stack([read_png(str(frame_dir / f)) for f in names])
        assert frames.shape == (8, 64, 48, 3) and frames.dtype == np.uint8
        assert (frames[t:] == frames[t - 1]).all()
    assert {"stage1_conditioner", "stage1_sampler", "stage2_dpt", "stage2_sampler",
            "stage2_io"} <= set(result["phases"])


def test_non_png_input_without_cv2_raises(tmp_path, monkeypatch):
    from hi3d_tpu_torch.utils.image import load_image_rgb

    path = tmp_path / "x.webp"
    path.write_bytes(b"RIFF\x00\x00\x00\x00WEBPVP8 ")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="only PNG and JPEG decode without cv2"):
        load_image_rgb(str(path))
