"""The port's GIF decoder (hi3d_tpu_torch/utils/gif.py) against cv2's
`imdecode(..., IMREAD_UNCHANGED)` (OpenCV 5.0's own GifDecoder), bit for
bit, with cv2 hidden from the port: cv2's GIFs of RGB and RGBA frames
and PIL's (adaptive palettes, grey, a transparency index, interlace)
at sizes 1×1 to 389×517; hand-built ones (tests/torch_raster.py) with a
frame smaller than the screen, local and global colour tables, interlace,
transparency in the first or a later frame, every LZW minimum code size,
GIF87a, extensions, several frames and a deferred clear; malformed and
damaged files.

tests/data/torch_gif/ holds the committed fixtures and goldens.json (shape
and SHA-256 of cv2's decode as RGB(A)); `python tests/test_torch_gif.py`
writes them again.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

import torch_threads  # noqa: F401
import cv2
import torch_raster as R
from torch_raster import one_torch_thread  # noqa: F401

FIXTURE_DIR = os.path.join(R.ROOT, "tests", "data", "torch_gif")


def _pal(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 3))


def _idx(h, w, n, seed):
    return np.random.RandomState(seed).randint(0, n, (h, w)).astype(np.uint8)


def _pil(img, **kw):
    f = io.BytesIO()
    img.save(f, "GIF", **kw)
    return f.getvalue()


def variants(h, w, seed=0):
    """(label, file) for every GIF variant with an (h, w) image."""
    rgb = R.demo(h, w, seed)
    rgba = np.concatenate([rgb, np.random.RandomState(seed).randint(0, 256, (h, w, 1))
                           .astype(np.uint8)], -1)
    out = [("cv2 RGB", cv2.imencode(".gif", rgb[..., ::-1].copy())[1].tobytes()),
           ("cv2 RGBA", cv2.imencode(".gif", rgba[..., [2, 1, 0, 3]].copy())[1].tobytes())]
    im = Image.fromarray(rgb)
    out += [("PIL adaptive", _pil(im)), ("PIL interlaced", _pil(im, interlace=True)),
            ("PIL grey", _pil(im.convert("L"))),
            ("PIL 16 colours, transparency 3", _pil(im.quantize(16), transparency=3)),
            ("PIL grey, transparency 0", _pil(im.convert("L"), transparency=0))]
    n = 1 << (seed % 8 + 1)
    idx = _idx(h, w, n, seed)
    big = (w + 5, h + 3)
    out += [
        ("small frame, GCT bg", R.gif(big, [{"idx": idx, "left": 3, "top": 2}], _pal(n, 1),
                                      bg=n - 1)),
        ("LCT only", R.gif(big, [{"idx": idx, "left": 5, "top": 3, "lct": _pal(n, 2)}])),
        ("GCT and LCT", R.gif((w, h), [{"idx": idx, "lct": _pal(n, 2)}], _pal(256, 3), bg=7)),
        ("interlaced", R.gif((w, h), [{"idx": idx, "interlace": True}], _pal(n, 4))),
        ("transparent", R.gif(big, [{"idx": idx, "left": 1, "top": 1,
                                     "transparent": int(idx[0, 0])}], _pal(n, 5), bg=0)),
        ("transparency in frame 2", R.gif(big, [{"idx": idx, "left": 2},
                                                {"idx": idx[:1, :1], "transparent": 0}],
                                          _pal(n, 6))),
        ("GIF87a", R.gif((w, h), [{"idx": idx}], _pal(n, 7), version=b"87a")),
        (f"min code size {max(2, n.bit_length() - 1)}",
         R.gif((w, h), [{"idx": idx, "min_code_size": max(2, n.bit_length() - 1)}], _pal(n, 8))),
        ("early clears", R.gif((w, h), [{"idx": idx, "clear_at": 300}], _pal(n, 9)))]
    ext = R.gif((w, h), [{"idx": idx}], _pal(n, 10))
    head = 13 + 3 * n
    out.append(("comment, application and plain-text extensions",
                ext[:head] + b"\x21\xfe\x03abc\x00" + b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
                + b"\x21\x01\x0c" + bytes(12) + b"\x00" + ext[head:]))
    if h * w > 5000:
        out.append(("deferred clear", R.gif((w, h), [{"idx": idx, "clear_at": None}],
                                            _pal(n, 11))))
    return out


FIXTURES = {
    "demo3_512.gif": lambda: cv2.imencode(".gif", cv2.imread(os.path.join(R.ROOT, "demo",
                                                                           "3.png")))[1].tobytes(),
    "cv2_rgb_17x23.gif": lambda: cv2.imencode(".gif", R.demo(17, 23)[..., ::-1].copy())[1]
    .tobytes(),
    "cv2_rgba_31x30.gif": lambda: cv2.imencode(".gif", np.concatenate(
        [R.demo(31, 30)[..., ::-1], _idx(31, 30, 256, 1)[..., None]], -1))[1].tobytes(),
    "pil_interlaced_29x37.gif": lambda: _pil(Image.fromarray(R.demo(29, 37)), interlace=True),
    "frame_on_screen_13x21.gif": lambda: R.gif((21, 13), [{"idx": _idx(7, 9, 16, 2), "left": 4,
                                                           "top": 3, "lct": _pal(16, 3),
                                                           "transparent": 5}], _pal(4, 4), bg=2),
}


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("size", R.SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_matches_cv2(size, tmp_path, monkeypatch):
    from hi3d_tpu_torch.utils.gif import decode_gif

    R.hide_cv2(monkeypatch)
    for k, (label, blob) in enumerate(variants(*size, seed=size[0])):
        path = str(tmp_path / f"{k}.gif") if size[0] <= 100 else None
        R.same_as_cv2(blob, decode_gif, f"{label} {size}", path)


def test_channels_follow_cv2s_rule():
    """(H, W, 4) exactly when some graphic control extension sets the
    transparency flag: PIL drops an index no pixel uses (3 channels),
    cv2 writes one for an RGBA frame (4)."""
    from hi3d_tpu_torch.utils.gif import decode_gif

    rgb = R.demo(17, 23)
    unused = _pil(Image.fromarray(rgb).convert("P"), transparency=255)
    used = _pil(Image.fromarray(rgb).quantize(16), transparency=3)
    assert decode_gif(unused).shape[-1] == R.cv2_rgb(unused).shape[-1] == 3
    assert decode_gif(used).shape[-1] == R.cv2_rgb(used).shape[-1] == 4


def test_fixtures_decode_to_their_goldens(monkeypatch):
    from hi3d_tpu_torch.utils.gif import read_gif
    from hi3d_tpu_torch.utils.image import read_image

    R.hide_cv2(monkeypatch)
    assert R.check_fixtures(FIXTURE_DIR, FIXTURES, read_gif) < 40_000
    R.check_fixtures(FIXTURE_DIR, FIXTURES, read_image)


def test_malformed_gifs_raise():
    """What cv2 refuses raises a ValueError naming the file: no trailer,
    bytes after the last block, a frame past the screen, a background or
    colour index past its table, a bad code size or control extension."""
    from hi3d_tpu_torch.utils.gif import decode_gif

    idx = _idx(5, 6, 4, 0)
    good = R.gif((6, 5), [{"idx": idx, "min_code_size": 2}], _pal(4, 0))
    cases = [(good[:-1], "no trailer"), (good[:-1] + b"\x99;", "kind 0x99"),
             (R.gif((5, 5), [{"idx": idx}], _pal(4, 0)), "on a 5×5 screen"),
             (R.gif((6, 5), [{"idx": idx}], _pal(4, 0), bg=9), "background index 9"),
             (R.gif((6, 5), [{"idx": idx + 4}], _pal(4, 0)), "colour index 7"),
             (R.gif((6, 5), [{"idx": idx % 2, "min_code_size": 1}], _pal(4, 0)), "minimum code"),
             (good[:13 + 12] + b"\x21\xf9\x03\x01\x00\x00\x00" + good[13 + 12:],
              "graphic control extension")]
    for blob, match in cases:
        assert R.cv2_rgb(blob) is None, match
        with pytest.raises(ValueError, match=f"bad.gif: .*{match}"):
            decode_gif(blob, "bad.gif")
    # without any colour table cv2 makes colours up; the port raises
    with pytest.raises(ValueError, match="bad.gif: .*without a colour table"):
        decode_gif(R.gif((6, 5), [{"idx": idx}]), "bad.gif")


@pytest.mark.parametrize("kind", ["cv2_rgba", "pil", "interlaced_lct"])
def test_damaged_files_raise_or_match_cv2(kind):
    from hi3d_tpu_torch.utils.gif import decode_gif

    blob = FIXTURES[{"cv2_rgba": "cv2_rgba_31x30.gif", "pil": "pil_interlaced_29x37.gif",
                     "interlaced_lct": "frame_on_screen_13x21.gif"}[kind]]()
    counts = R.damaged(blob, decode_gif, seed=len(blob), flips=300)
    assert sum(counts.values()) > 300


if __name__ == "__main__":
    R.write_fixtures(FIXTURE_DIR, FIXTURES)
