"""The port's image and video IO against hi3d_tpu's, on CPU.

- Filtered and palette PNGs: the port decodes PNG with its own reader
  (`hi3d_tpu_torch.utils.png`, its scanline filters undone in C), the JAX
  package with cv2. Rows under all five filter types at 1–4 bytes a pixel
  and in a palette image must decode as cv2 and as the plain Python loop. Indexed-colour
  files written by PIL at 1, 2, 4 and 8 bits, with and without a tRNS chunk,
  must load identically through `load_image_rgb` (inference) and through the
  render reader of the training data (white composite).
- Stage 2's default input: both packages' v2v read the stage-1 mp4 (the
  port's own H.264 file). Both must select the same frames when the stage-1
  clip is not a whole number of seconds at `fps`. The JAX mp4 is captured as
  the padded frame list its `export_to_video` hands its writer, passed
  through the port's codec (a deterministic encode: its reconstruction is
  what the port's decoder returns).

Exact comparisons: both sides decode the same bytes and resize flat frames.
"""

import sys
import types

import numpy as np
import pytest
from PIL import Image

import torch_threads  # noqa: F401
from hi3d_tpu.data import video_dataset as jax_video_dataset
from hi3d_tpu.utils.image import load_image_rgb as jax_load_image_rgb
from hi3d_tpu_torch.data.video_dataset import rgba_white
from hi3d_tpu_torch.utils.image import load_image_rgb
from hi3d_tpu_torch.utils.png import read_png


def _palette_png(path, bits: int, trns: bool, seed: int) -> None:
    """A 9×13 indexed-colour PNG (13 columns: sub-byte rows end mid-byte)."""
    rnd = np.random.RandomState(seed)
    n = 1 << bits
    im = Image.fromarray(rnd.randint(0, n, (9, 13)).astype(np.uint8), "P")
    im.putpalette(rnd.randint(0, 256, 3 * n).astype(np.uint8).tolist())
    extra = {"transparency": bytes([0, 96, 255][:min(3, n - 1)])} if trns else {}
    im.save(path, bits=bits, **extra)


FILTERS = (0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 3, 4)  # every pair of neighbouring filter types


def _filter_rows(rows, bpp: int, filters) -> np.ndarray:
    """(H, stride) uint8 rows → (H, 1 + stride) PNG scanlines, row y under
    filter type filters[y % len(filters)] (0 None … 4 Paeth)."""
    x = rows.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, bpp:] = x[:, :-bpp]
    b[1:] = x[:-1]
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    for y in range(x.shape[0]):
        f = filters[y % len(filters)]
        out[y, 0] = f
        out[y, 1:] = (x[y] - preds[f][y]) & 0xFF
    return out


def _filtered_png(path, img, palette=None) -> None:
    """`img` (H, W, C) written with rows cycling through all five filter
    types; with `palette`, (H, W) indices as an 8-bit indexed-colour PNG."""
    import struct
    import zlib

    from hi3d_tpu_torch.utils import png

    if palette is None:
        h, w, ch = img.shape
        ctype, bpp = {1: 0, 2: 4, 3: 2, 4: 6}[ch], ch
    else:
        (h, w), ctype, bpp = img.shape, 3, 1
    rows = _filter_rows(img.reshape(h, -1), bpp, FILTERS)
    with open(path, "wb") as f:
        f.write(png._SIGNATURE)
        f.write(png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        if palette is not None:
            f.write(png._chunk(b"PLTE", palette.tobytes()))
        f.write(png._chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(png._chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4, "palette"])
def test_filtered_png_decodes_as_cv2(tmp_path, channels):
    """Rows under every filter type (None, Sub, Up, Average, Paeth) at 1–4
    bytes a pixel and in a palette image: the C unfilter decodes them as cv2
    does (through JAX `load_image_rgb`) and as the plain Python loop."""
    import zlib

    from hi3d_tpu_torch.utils import png

    rnd = np.random.RandomState(7 + (channels if channels != "palette" else 0))
    path = str(tmp_path / f"f{channels}.png")
    if channels == "palette":
        img = rnd.randint(0, 256, (24, 19)).astype(np.uint8)
        _filtered_png(path, img, rnd.randint(0, 256, (256, 3)).astype(np.uint8))
        stride, bpp = 19, 1
    else:
        img = rnd.randint(0, 256, (24, 19, channels)).astype(np.uint8)
        img[5:9] = img[4]  # flat runs, where the predictors tie
        _filtered_png(path, img)
        stride, bpp = 19 * channels, channels
        np.testing.assert_array_equal(read_png(path), img)
    with open(path, "rb") as f:
        blob = f.read()
    idat = blob.index(b"IDAT")
    raw = zlib.decompress(blob[idat + 4:idat + 4 + int.from_bytes(blob[idat - 4:idat], "big")])
    assert {raw[y * (stride + 1)] for y in range(24)} == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(png._unfilter(raw, 24, stride, bpp),
                                  png._unfilter_reference(raw, 24, stride, bpp))
    np.testing.assert_array_equal(load_image_rgb(path), jax_load_image_rgb(path))
    with pytest.raises(ValueError, match="unknown PNG filter type 7 in row 2"):
        bad = bytearray(raw)
        bad[2 * (stride + 1)] = 7
        png._unfilter(bytes(bad), 24, stride, bpp)


def test_unfilter_builds_once_under_loader_threads(tmp_path, monkeypatch):
    """Eight threads of one process read PNGs at once against an empty build
    directory, as the training loader's threads do in a fresh checkout: the
    C unfilter is built once, loaded whole, and every frame decodes."""
    from concurrent.futures import ThreadPoolExecutor

    from hi3d_tpu_torch.utils import png

    img = np.random.RandomState(5).randint(0, 256, (16, 11, 4)).astype(np.uint8)
    path = str(tmp_path / "frame.png")
    _filtered_png(path, img)
    build = tmp_path / "build"
    monkeypatch.setattr(png, "_BUILD_DIR", build)
    monkeypatch.setattr(png, "_lib", None)
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(lambda _: read_png(path), range(16)))
    for frame in frames:
        np.testing.assert_array_equal(frame, img)
    assert [p.suffix for p in build.iterdir()] == [".so"]


@pytest.mark.parametrize("bits,trns", [(8, False), (4, False), (2, False), (1, False),
                                       (8, True), (4, True), (1, True)])
def test_palette_png_loads_as_in_jax(tmp_path, bits, trns):
    path = str(tmp_path / f"p{bits}{'t' if trns else ''}.png")
    _palette_png(path, bits, trns, seed=bits + 10 * trns)
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[24:26] == bytes([bits, 3]) and (b"tRNS" in blob) == trns
    raw = read_png(path)
    assert raw.shape == (9, 13, 4 if trns else 3)
    np.testing.assert_array_equal(load_image_rgb(path), jax_load_image_rgb(path))
    want_rgb, _ = jax_video_dataset.load_rgba_white(path)
    np.testing.assert_array_equal(rgba_white(raw), want_rgb)


def test_stage2_default_input_selects_jax_frames(tmp_path, monkeypatch):
    """31 stage-1 frames at fps 8, clip_size 20: the port's v2v on its
    default input, first.mp4, picks the frames JAX's v2v picks from the
    mp4."""
    from hi3d_tpu.pipelines import v2v as jax_v2v
    from hi3d_tpu.utils.video import export_to_video as jax_export_to_video
    from hi3d_tpu_torch.pipelines.v2v import prepare_inputs
    from hi3d_tpu_torch.utils import h264
    from hi3d_tpu_torch.utils.png import write_png
    from hi3d_tpu_torch.utils.video import export_to_video

    t, fps, clip, res = 31, 8, 20, 16
    colours = np.random.RandomState(3).permutation(256)[:t]
    frames = [np.full((res, res, 3), (c, 255 - c, (7 * c) % 256), np.uint8) for c in colours]
    clean = str(tmp_path / "clean.png")
    write_png(clean, np.full((res, res, 3), (20, 200, 90), np.uint8))

    mp4 = []

    class _Writer:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def append_data(self, f):
            mp4.append(np.asarray(f))

    with monkeypatch.context() as m:  # no cv2 or imageio writer on the port's side
        m.setitem(sys.modules, "cv2", None)
        m.setitem(sys.modules, "imageio", None)
        first = export_to_video(frames, str(tmp_path / "first_step" / "first.mp4"), fps=fps)
        m.setitem(sys.modules, "imageio",
                  types.SimpleNamespace(get_writer=lambda *a, **kw: _Writer()))
        jax_export_to_video(frames, str(tmp_path / "jax" / "first.mp4"), fps=fps)
    assert len(mp4) == 32 and first.endswith("first.mp4")
    coded = [h264.to_rgb(*r) for r in h264.encode(mp4, 5, fps).recon]
    monkeypatch.setattr(jax_v2v, "import_video", lambda path: list(coded))
    want, want_masks = jax_v2v.prepare_inputs(clean, "first.mp4", clip, (res, res))
    got, got_masks = prepare_inputs(clean, first, clip, (res, res))
    assert got.shape == (clip, res, res, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_masks, want_masks)
    np.testing.assert_array_equal(got[-1], coded[-1])  # the padded tail
    np.testing.assert_array_equal(got[1], coded[32 - clip + 1])  # not frames[t - clip + 1]
    assert np.abs(coded[32 - clip + 1].astype(int) - frames[32 - clip + 1]).max() <= 3
