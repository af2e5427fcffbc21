"""The port's image and video IO against hi3d_tpu's, on CPU.

- Palette PNGs: the port decodes PNG with its stdlib reader
  (`hi3d_tpu_torch.utils.png`), the JAX package with cv2. Indexed-colour
  files written by PIL at 1, 2, 4 and 8 bits, with and without a tRNS chunk,
  must load identically through `load_image_rgb` (inference) and through the
  render reader of the training data (white composite).
- Stage 2's default input: the port's v2v reads the stage-1 frames directory,
  the JAX package the stage-1 mp4. Both must select the same frames when the
  stage-1 clip is not a whole number of seconds at `fps`. The JAX mp4 is
  captured as the padded frame list its `export_to_video` hands its writer.

Exact comparisons: both sides decode the same bytes and resize flat frames.
"""

import sys
import types

import numpy as np
import pytest
from PIL import Image

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
    """31 stage-1 frames at fps 8, clip_size 20: the port's v2v on the
    frames directory picks the frames JAX's v2v picks from the mp4."""
    from hi3d_tpu.pipelines import v2v as jax_v2v
    from hi3d_tpu.utils.video import export_to_video as jax_export_to_video
    from hi3d_tpu_torch.pipelines.v2v import prepare_inputs
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

    with monkeypatch.context() as m:  # no mp4 writer on either side
        m.setitem(sys.modules, "cv2", None)
        m.setitem(sys.modules, "imageio", None)
        frame_dir = export_to_video(frames, str(tmp_path / "first_step" / "first.mp4"), fps=fps)
        m.setitem(sys.modules, "imageio",
                  types.SimpleNamespace(get_writer=lambda *a, **kw: _Writer()))
        jax_export_to_video(frames, str(tmp_path / "jax" / "first.mp4"), fps=fps)
    assert len(mp4) == 32
    monkeypatch.setattr(jax_v2v, "import_video", lambda path: list(mp4))
    want, want_masks = jax_v2v.prepare_inputs(clean, "first.mp4", clip, (res, res))
    got, got_masks = prepare_inputs(clean, frame_dir, clip, (res, res))
    assert got.shape == (clip, res, res, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_masks, want_masks)
    np.testing.assert_array_equal(got[-1], frames[-1])  # the padded tail
    np.testing.assert_array_equal(got[1], frames[32 - clip + 1])  # not frames[t - clip + 1]
