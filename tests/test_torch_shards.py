"""Tar-shard datasets and the eval set: hi3d_tpu_torch against hi3d_tpu on
the CPU.

- `pack_folder_to_shards` writes the same shards and members as JAX's;
  `_host_shards` gives each process the same shards in every epoch; one
  RandomState gives the same samples: captions, elevations, masks and
  frame kernels equal, videos within the folder dataset's bound (one grey
  level where the frames are resized, exact where they are not: the port's
  float bilinear against cv2's fixed-point weights).
- `prepare_eval_input` and `SyncDreamerEvalData` bit-equal to JAX's, which
  resizes with PIL, on RGBA and RGB PNGs of odd sizes.
"""

import io
import os
import tarfile

import numpy as np
import pytest

import torch_threads  # noqa: F401
from test_torch_stage2_training import _NoIPP
from test_torch_training import _write_renders


def _shards(tmp_path, n_objects, size, per_shard=2, seed=0):
    from hi3d_tpu_torch.data.video_dataset import pack_folder_to_shards

    renders = _write_renders(tmp_path / "renders", n_objects, size, seed=seed)
    return renders, pack_folder_to_shards(renders, str(tmp_path / "shards"), per_shard)


def _members(path):
    with tarfile.open(path) as tf:
        return [m.name for m in tf.getmembers()]


def test_pack_folder_to_shards_matches_jax(tmp_path):
    from hi3d_tpu.data.video_dataset import pack_folder_to_shards as jax_pack

    renders, ours = _shards(tmp_path, 3, 8)
    ref = jax_pack(renders, str(tmp_path / "jax"), 2)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref] == [
        "renders-00000.tar", "renders-00001.tar"]
    for a, b in zip(ours, ref):
        assert _members(a) == _members(b)
    assert _members(ours[1]) == [f"obj2/{i:03d}.png" for i in range(96)]


@pytest.mark.parametrize("count,shuffle", [(1, True), (2, True), (2, False), (7, True)])
def test_host_shards_match_jax(count, shuffle):
    """Each process's shards in epochs 0 and 1 (7 processes over 5 shards:
    every process falls back to all of them)."""
    from hi3d_tpu.data.video_dataset import TarShardVideoDataset as JaxShards
    from hi3d_tpu_torch.data.video_dataset import TarShardVideoDataset

    shards = [f"/data/renders-{i:05d}.tar" for i in (3, 0, 4, 1, 2)]
    seen = set()
    for index in range(count):
        kw = dict(seed=5, shuffle_shards=shuffle, process_index=index, process_count=count)
        ours, ref = TarShardVideoDataset(shards, **kw), JaxShards(shards, **kw)
        for epoch in (0, 1):
            assert ours._host_shards(epoch) == ref._host_shards(epoch)
            seen.update(ours._host_shards(epoch))
    assert seen == set(shards)
    if count == 1:
        assert TarShardVideoDataset(shards, seed=5)._host_shards(0) != TarShardVideoDataset(
            shards, seed=5)._host_shards(1)  # reshuffled every epoch


@pytest.mark.parametrize("stage2", [False, True])
@pytest.mark.parametrize("size,target", [(32, 32), (40, 32)])
def test_tar_sample_matches_jax(tmp_path, stage2, size, target):
    """Five samples in a row (objects stream across the two shards and
    around again) with one RandomState on each side."""
    from hi3d_tpu.data import video_dataset as jax_vd
    from hi3d_tpu_torch.data import video_dataset as vd

    _, shards = _shards(tmp_path, 3, size, seed=size)
    name = "TarShardVideoDatasetStage2" if stage2 else "TarShardVideoDataset"
    kw = dict(width=target, height=target, sample_frames=16, seed=1, process_index=0,
              process_count=1)
    ours = getattr(vd, name)(str(tmp_path / "shards" / "*.tar"), **kw)
    ref = getattr(jax_vd, name)(str(tmp_path / "shards" / "*.tar"), **kw)
    r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
    bound = 0.0 if size == target else 1.0 / 127.5 + 1e-6
    for _ in range(5):
        got = ours.sample(r1)
        with _NoIPP():
            want = ref.sample(r2)
        assert set(got) == set(want)
        assert got["caption"] == want["caption"] and got["elevation"] == want["elevation"]
        assert got["video"].shape == (16, 3, target, target) and got["video"].dtype == np.float32
        assert np.abs(got["video"].transpose(0, 2, 3, 1) - want["video"]).max() <= bound
        if stage2:
            assert "fps_id" not in got and got["caption"].startswith("obj")
            np.testing.assert_array_equal(got["masks"], want["masks"])
            for k in ("kernel1s", "kernel2s", "sinc_kernels"):
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got["fps_id"] == 7 and got["motion_bucket_id"] == 127


def test_jpeg_member_raises(tmp_path):
    """JAX decodes a JPEG member with cv2; the port reads PNG only and says so."""
    from hi3d_tpu_torch.data.video_dataset import TarShardVideoDataset

    path = str(tmp_path / "jpeg.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(16):
            data = b"\xff\xd8\xff\xe0" + bytes(16)
            info = tarfile.TarInfo(f"obj0/{i:03d}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    with pytest.raises(ValueError, match="obj0/0.*JPEG.*PNG"):
        TarShardVideoDataset(path, 16, 16).sample(np.random.RandomState(0))


def test_data_modules_route_tar_shards_with_their_kwargs(tmp_path):
    """`data.params.base_folder=<glob of .tar>` with shuffle_shards,
    process_index and process_count (which the port's data module refused
    before) goes to the tar dataset with them, in both stages and both
    packages; degradation_opt reaches the stage-2 one."""
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.data.video_dataset import (
        TarShardVideoDataset,
        TarShardVideoDatasetStage2,
    )

    _shards(tmp_path, 3, 16)
    for target, cls in (("sgm.data.video_dataset.VideoDataset", TarShardVideoDataset),
                        ("sgm.data.video_dataset_stage2_degradeImages.VideoDataset",
                         TarShardVideoDatasetStage2)):
        cfg = {"target": target, "params": {
            "base_folder": str(tmp_path / "shards" / "*.tar"), "width": 16, "height": 16,
            "sample_frames": 4, "batch_size": 2, "num_workers": 1, "seed": 3,
            "shuffle_shards": False, "process_index": 1, "process_count": 2,
            "degradation_opt": {"final_sinc_prob": 0.0}, "depth_folder": "unused"}}
        data = instantiate_from_config(cfg).setup()
        ref = jax_instantiate(cfg).setup()
        assert type(data.train_dataset) is cls
        assert data.train_dataset._host_shards(0) == ref.train_dataset._host_shards(0) == [
            str(tmp_path / "shards" / "renders-00001.tar")]
        loader = data.train_dataloader()
        batch = next(loader)
        loader.close()
        assert batch["video"].shape == (2, 4, 3, 16, 16)
        assert all(c.startswith("obj2") for c in batch["caption"])
        if cls is TarShardVideoDatasetStage2:
            assert (batch["sinc_kernels"][..., 10, 10] == 1).all()  # final_sinc_prob 0


def _png(path, img):
    from hi3d_tpu_torch.utils.png import write_png

    write_png(str(path), img)
    return str(path)


def _rgba(h, w, seed, box):
    """Random RGBA with alpha 0 outside `box` (y0, y1, x0, x1) and some
    translucent pixels inside."""
    rnd = np.random.RandomState(seed)
    img = rnd.randint(0, 256, (h, w, 4)).astype(np.uint8)
    y0, y1, x0, x1 = box
    alpha = np.zeros((h, w), np.uint8)
    alpha[y0:y1, x0:x1] = np.where(rnd.rand(y1 - y0, x1 - x0) < 0.7, 255,
                                   rnd.randint(1, 255, (y1 - y0, x1 - x0)))
    img[..., 3] = alpha
    return img


@pytest.mark.parametrize("case", ["rgba_up", "rgba_down", "rgba_wide", "rgb", "rgba_nocrop"])
def test_prepare_eval_input_bit_equal_to_jax(tmp_path, case):
    from hi3d_tpu.data.video_dataset import prepare_eval_input as jax_prepare
    from hi3d_tpu_torch.data.video_dataset import prepare_eval_input

    if case == "rgba_up":  # the alpha box is upscaled to crop_size
        img, crop, size = _rgba(37, 29, 0, (3, 33, 2, 27)), 64, 96
    elif case == "rgba_down":  # reduced: PIL's support widens (antialiasing)
        img, crop, size = _rgba(301, 223, 1, (10, 290, 7, 219)), 80, 101
    elif case == "rgba_wide":  # wider than tall, one column of alpha at the edge
        img, crop, size = _rgba(45, 131, 2, (20, 30, 0, 131)), 90, 90
    elif case == "rgb":  # black-padded square, then resized
        img, crop, size = np.random.RandomState(3).randint(0, 256, (51, 37, 3)).astype(
            np.uint8), 64, 75
    else:  # RGBA without a crop: padded and resized premultiplied
        img, crop, size = _rgba(33, 47, 4, (5, 30, 9, 40)), -1, 61
    path = _png(tmp_path / "eval.png", img)
    want = jax_prepare(path, 30.0, crop, size)
    got = prepare_eval_input(path, 30.0, crop, size)
    assert got["input_image"].shape == (size, size, 3) and got["input_image"].dtype == np.float32
    np.testing.assert_array_equal(got["input_image"], want["input_image"])
    assert got["input_elevation"] == want["input_elevation"]
    assert got["input_elevation"].dtype == np.float32


def test_eval_set_matches_jax(tmp_path):
    """Every `.png` of the folder in name order, each bit-equal to JAX's at
    512²; the data module builds it from `eval_folder` and `val_dataloader`
    returns it; a palette or gray PNG raises in the port (JAX's PIL path
    returns a two-dimensional array for it)."""
    from hi3d_tpu.data.video_dataset import SyncDreamerEvalData as JaxEval
    from hi3d_tpu_torch.data.video_dataset import (
        SyncDreamerEvalData,
        VideoDataset,
        prepare_eval_input,
    )

    d = tmp_path / "eval"
    d.mkdir()
    _png(d / "b.png", _rgba(40, 52, 5, (4, 36, 6, 50)))
    _png(d / "a.png", np.random.RandomState(6).randint(0, 256, (20, 30, 3)).astype(np.uint8))
    (d / "notes.txt").write_text("not an image")
    ours, ref = SyncDreamerEvalData(str(d)), JaxEval(str(d))
    assert len(ours) == len(ref) == 2 and [f.name for f in ours.fns] == ["a.png", "b.png"]
    for i in range(2):
        np.testing.assert_array_equal(ours[i]["input_image"], ref[i]["input_image"])
    renders = _write_renders(tmp_path / "renders", 1, 16, seed=7)
    data = VideoDataset(renders, eval_folder=str(d), width=16, height=16).setup()
    val = data.val_dataloader()
    assert isinstance(val, SyncDreamerEvalData)
    first = next(iter(val))
    assert set(first) == {"input_image", "input_elevation"}
    assert first["input_image"].shape == (512, 512, 3)
    _png(tmp_path / "gray.png", np.zeros((8, 8, 1), np.uint8))
    with pytest.raises(ValueError, match="colour type 0"):
        prepare_eval_input(str(tmp_path / "gray.png"), 0.0, 512, 512)


def test_eval_set_shards_and_captions_run_without_jax_pil_or_cv2(tmp_path):
    """In a process where jax, hi3d_tpu, PIL, cv2, imageio and tensorboard do
    not import (the card's machine has none of them): the eval set, a tar
    shard's sample, the caption images and the metrics logger's fallback."""
    import subprocess
    import sys

    from hi3d_tpu_torch.data.video_dataset import pack_folder_to_shards

    renders = _write_renders(tmp_path / "renders", 1, 16, seed=8)
    pack_folder_to_shards(renders, str(tmp_path / "shards"))
    d = tmp_path / "eval"
    d.mkdir()
    _png(d / "a.png", _rgba(30, 20, 9, (2, 28, 3, 17)))
    code = f"""
import sys
for name in ('jax', 'hi3d_tpu', 'PIL', 'cv2', 'imageio', 'tensorboard', 'torch.utils.tensorboard'):
    sys.modules[name] = None
import numpy as np, torch
from hi3d_tpu_torch.data.video_dataset import SyncDreamerEvalData, TarShardVideoDatasetStage2
from hi3d_tpu_torch.training.trainer import MetricsLogger
from hi3d_tpu_torch.utils.image import log_txt_as_img
item = SyncDreamerEvalData({str(d)!r})[0]
assert item['input_image'].shape == (512, 512, 3)
s = TarShardVideoDatasetStage2({str(tmp_path / 'shards' / '*.tar')!r}, 16, 16, 4).sample(
    np.random.RandomState(0))
assert s['video'].shape == (4, 3, 16, 16) and s['masks'].shape == (4, 16, 16)
img = log_txt_as_img((512, 512), ['obj0_000.png'], size=16)
assert img.shape == (1, 512, 512, 3) and img.min() == -1.0
MetricsLogger({str(tmp_path)!r}, torch.device('cpu'), backend='tensorboard')
assert not any(sys.modules.get(k) for k in ('jax', 'hi3d_tpu', 'PIL', 'cv2', 'imageio'))
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "tensorboard backend unavailable" in out.stdout and out.stdout.endswith("ok\n")
