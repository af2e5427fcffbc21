"""The training loaders on render frames in the raster formats cv2 reads
besides PNG, JPEG and WebP (BMP, TIFF, GIF, PNM, Sun raster), against the
JAX package's loaders, which read every file through cv2: the folder
dataset and the tar-shard dataset, stage 1 and stage 2 (masks included),
sample what JAX's sample on the same seed, with cv2 hidden from the port.
The port's loaders refused all five formats before utils/image.py's
signature table took them. Also: an AVIF or JPEG 2000 frame raises
`Unsupported` naming the format with cv2 hidden (and is handed to cv2
where it imports); 16-bit TIFF and PNM frames raise on every host."""

import io
import tarfile

import numpy as np
import pytest

import torch_threads  # noqa: F401
import cv2
import torch_raster as R
from torch_raster import one_torch_thread  # noqa: F401

FRAMES = 32  # two elevation bands of 16


def _frame(i: int) -> np.ndarray:
    """A 16² BGRA frame: demo/3.png's colours, alpha in steps so that the
    masks have both sides."""
    bgr = R.demo(16, 16, seed=i)[..., ::-1]
    a = np.full((16, 16, 1), 255, np.uint8)
    a[:5] = 0
    a[5:9, :7] = 90 + i
    return np.concatenate([bgr, a], -1)


def _encode(ext: str, bgra: np.ndarray) -> bytes:
    if ext in (".ppm", ".ras"):
        return cv2.imencode(ext, np.ascontiguousarray(bgra[..., :3]))[1].tobytes()
    return cv2.imencode(ext, bgra)[1].tobytes()


def _renders(tmp_path, ext: str):
    """A render folder of FRAMES frames and a tar shard of the same."""
    folder = tmp_path / "renders" / "obj0"
    folder.mkdir(parents=True)
    shard = str(tmp_path / f"frames{ext}.tar")
    with tarfile.open(shard, "w") as tf:
        for i in range(FRAMES):
            data = _encode(ext, _frame(i))
            (folder / f"{i:03d}{ext}").write_bytes(data)
            info = tarfile.TarInfo(f"obj0/{i:03d}{ext}")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return str(tmp_path / "renders"), shard


@pytest.mark.parametrize("ext", [".bmp", ".tif", ".gif", ".ppm", ".ras"])
def test_loaders_sample_what_jax_samples(tmp_path, monkeypatch, ext):
    import hi3d_tpu.data.native_loader as native_loader
    from hi3d_tpu.data import video_dataset as jax_vd
    from hi3d_tpu_torch.data import video_dataset as vd
    from test_torch_stage2_training import _NoIPP

    monkeypatch.setattr(native_loader, "available", lambda: False)  # JAX side on cv2
    R.hide_cv2(monkeypatch)
    root, shard = _renders(tmp_path, ext)
    kw = dict(width=16, height=16, sample_frames=16)
    for stage2 in (False, True):
        name = "VideoTrainDatasetStage2" if stage2 else "VideoTrainDataset"
        for seed in (2, 7):
            got = getattr(vd, name)(root, **kw).sample(np.random.RandomState(seed))
            with _NoIPP():
                want = getattr(jax_vd, name)(root, **kw).sample(np.random.RandomState(seed))
            assert got["caption"] == want["caption"]
            np.testing.assert_array_equal(got["video"].transpose(0, 2, 3, 1), want["video"])
            if stage2:
                np.testing.assert_array_equal(got["masks"], want["masks"][..., 0]
                                              if want["masks"].ndim == 4 else want["masks"])
                assert 0 < got["masks"].mean() < 1 or ext in (".ppm", ".ras")
        name = "TarShardVideoDatasetStage2" if stage2 else "TarShardVideoDataset"
        tkw = dict(kw, seed=1, process_index=0, process_count=1)
        got = getattr(vd, name)(shard, **tkw).sample(np.random.RandomState(0))
        with _NoIPP():
            want = getattr(jax_vd, name)(shard, **tkw).sample(np.random.RandomState(0))
        np.testing.assert_array_equal(got["video"].transpose(0, 2, 3, 1), want["video"])
        if stage2:
            np.testing.assert_array_equal(got["masks"], want["masks"])


def _other_formats():
    """An AVIF and a JPEG 2000 image, as cv2 writes them."""
    img = np.ascontiguousarray(R.demo(64, 64)[..., ::-1])
    return [("AVIF", cv2.imencode(".avif", img)[1].tobytes()),
            ("JPEG 2000", cv2.imencode(".jp2", img)[1].tobytes())]


@pytest.mark.parametrize("fmt", ["AVIF", "JPEG 2000"])
def test_formats_the_port_does_not_decode(tmp_path, monkeypatch, fmt):
    """With cv2 hidden, read_image, decode_image and both datasets raise
    `Unsupported` naming the format; with cv2 they decode as cv2 does."""
    from hi3d_tpu_torch.data import video_dataset as vd
    from hi3d_tpu_torch.utils import image
    from hi3d_tpu_torch.utils.raster import Unsupported

    blob = dict(_other_formats())[fmt]
    folder = tmp_path / "renders" / "obj0"
    folder.mkdir(parents=True)
    shard = str(tmp_path / "x.tar")
    with tarfile.open(shard, "w") as tf:
        for i in range(16):
            (folder / f"{i:03d}.img").write_bytes(blob)
            info = tarfile.TarInfo(f"obj0/{i:03d}.img")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    path = str(folder / "000.img")
    np.testing.assert_array_equal(image.read_image(path), R.cv2_rgb(blob))
    kw = dict(width=16, height=16, sample_frames=16)
    assert vd.VideoTrainDataset(str(tmp_path / "renders"), **kw).sample(
        np.random.RandomState(0))["video"].shape == (16, 3, 16, 16)
    R.hide_cv2(monkeypatch)
    for call in (lambda: image.read_image(path), lambda: image.decode_image(blob, path),
                 lambda: image.load_image_rgb(path),
                 lambda: vd.VideoTrainDataset(str(tmp_path / "renders"), **kw).sample(
                     np.random.RandomState(0)),
                 lambda: vd.TarShardVideoDataset(shard, **kw, seed=1, process_index=0,
                                                 process_count=1).sample(
                     np.random.RandomState(0))):
        with pytest.raises(Unsupported, match=f"a {fmt} image, which the port does not "
                                              "decode"):
            call()


@pytest.mark.parametrize("ext", [".tif", ".pgm"])
def test_sixteen_bit_frames_raise_on_every_host(tmp_path, monkeypatch, ext):
    """cv2 returns uint16 for these, which JAX's / 255 mishandles: the
    folder dataset raises a ValueError whether cv2 imports or not."""
    from hi3d_tpu_torch.data import video_dataset as vd
    from hi3d_tpu_torch.utils.raster import Unsupported

    folder = tmp_path / "renders" / "obj0"
    folder.mkdir(parents=True)
    img = R.demo(16, 16)[..., 0 if ext == ".pgm" else slice(None)].astype(np.uint16) * 257
    for i in range(16):
        cv2.imwrite(str(folder / f"{i:03d}{ext}"), img)
    kw = dict(width=16, height=16, sample_frames=16)
    for hidden in (False, True):
        if hidden:
            R.hide_cv2(monkeypatch)
        with pytest.raises(ValueError, match="16-bit") as e:
            vd.VideoTrainDataset(str(tmp_path / "renders"), **kw).sample(np.random.RandomState(0))
        assert not isinstance(e.value, Unsupported)
