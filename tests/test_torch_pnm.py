"""The port's PNM and Sun raster decoders (hi3d_tpu_torch/utils/pnm.py,
utils/sunras.py) against cv2's `imdecode(..., IMREAD_UNCHANGED)` (OpenCV
5.0's PxMDecoder and SunRasterDecoder), bit for bit, with cv2 hidden from
the port: cv2's and PIL's PBM, PGM and PPM and hand-built ASCII ones
(P1-P3: comments, packed P1 digits, maxval below 255, samples past it) at
sizes 1×1 to 389×517; cv2's Sun rasters (24 bits; 8-bit grey, which cv2
5.0 reads back black) and hand-built ones with colormaps (1 and 8 bits,
grey or colour, short), 32 bits and the old type; 16-bit PNMs raising on
every host; the refusals; damaged files.

tests/data/torch_pnm/ holds the committed fixtures and goldens.json (shape
and SHA-256 of cv2's decode as RGB); `python tests/test_torch_pnm.py`
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

FIXTURE_DIR = os.path.join(R.ROOT, "tests", "data", "torch_pnm")


def _ascii(kind, img, maxval, sep=b" ", header=None, per_line=17):
    """P1 (img of 0/1), P2 or P3 in ASCII; `header` replaces the header."""
    h, w = img.shape[:2]
    vals = img.reshape(-1)
    lines = [sep.join(str(int(v)).encode() for v in vals[i:i + per_line])
             for i in range(0, vals.size, per_line)]
    head = header or (f"P{kind}\n{w} {h}\n" + ("" if kind == 1 else f"{maxval}\n")).encode()
    return head + b"\n".join(lines) + b"\n"


def _pil(img, mode, fmt="PPM"):
    f = io.BytesIO()
    Image.fromarray(img).convert(mode).save(f, fmt)
    return f.getvalue()


def pnm_variants(h, w, seed=0):
    rgb = R.demo(h, w, seed)
    rnd = np.random.RandomState(seed)
    out = [("cv2 P6", cv2.imencode(".ppm", rgb[..., ::-1].copy())[1].tobytes()),
           ("cv2 P5", cv2.imencode(".pgm", rgb[..., 0].copy())[1].tobytes()),
           ("cv2 P4", cv2.imencode(".pbm", rgb[..., 0].copy())[1].tobytes()),
           ("PIL P6", _pil(rgb, "RGB")), ("PIL P5", _pil(rgb, "L")), ("PIL P4", _pil(rgb, "1"))]
    bits = rnd.randint(0, 2, (h, w))
    out += [("P1", _ascii(1, bits, 1)),
            ("P1 packed digits", b"P1\n%d %d\n" % (w, h) + b"\n".join(
                b"".join(b"%d" % v for v in row) for row in bits) + b"\n"),
            ("P2", _ascii(2, rgb[..., 0], 255)), ("P3", _ascii(3, rgb, 255)),
            ("P2 maxval 100, samples past it", _ascii(2, rnd.randint(0, 140, (h, w)), 100)),
            ("P3 maxval 15", _ascii(3, rnd.randint(0, 16, (h, w, 3)), 15)),
            ("P2 comments, tabs, CRLF", _ascii(
                2, rgb[..., 1], 255, sep=b"\t", per_line=5,
                header=b"P2 # a comment\r\n# another\r\n%d\t%d # size\n255\n" % (w, h))),
            ("P5 maxval 100 (raw bytes)", b"P5\n%d %d\n100\n" % (w, h) + rgb[..., 2].tobytes()),
            ("P6 comment before maxval", b"P6 %d %d\n#c\n255\r" % (w, h) + rgb.tobytes())]
    return out


def sun_variants(h, w, seed=0):
    rgb = R.demo(h, w, seed)
    rnd = np.random.RandomState(seed)
    out = [("cv2 24", cv2.imencode(".ras", rgb[..., ::-1].copy())[1].tobytes()),
           ("cv2 grey (black in cv2 5.0)", cv2.imencode(".ras", rgb[..., 0].copy())[1].tobytes()),
           ("24 old type", R.sunras(rgb[..., ::-1], 24, kind=0)),
           ("32 XBGR", R.sunras(np.concatenate([rnd.randint(0, 256, (h, w, 1)).astype(np.uint8),
                                                rgb[..., ::-1]], -1), 32))]
    for depth in (1, 8):
        n = 1 << depth
        idx = rnd.randint(0, n, (h, w))
        colour = rnd.randint(0, 256, (3, n))
        grey = np.repeat(rnd.randint(0, 256, (1, n)), 3, 0)
        out += [(f"{depth} colour map", R.sunras(idx, depth, cmap=colour)),
                (f"{depth} grey map", R.sunras(idx, depth, cmap=grey)),
                (f"{depth} short map", R.sunras(idx, depth, cmap=colour[:, :max(1, n // 2)])),
                (f"{depth} no map (black in cv2 5.0)", R.sunras(idx, depth))]
    return out


FIXTURES = {
    "p6_17x23.ppm": lambda: cv2.imencode(".ppm", R.demo(17, 23)[..., ::-1].copy())[1].tobytes(),
    "p4_13x21.pbm": lambda: _pil(R.demo(13, 21), "1"),
    "p3_maxval15_7x9.ppm": lambda: _ascii(3, np.random.RandomState(1).randint(0, 16, (7, 9, 3)),
                                          15),
    "p2_comments_9x7.pgm": lambda: _ascii(2, R.demo(9, 7)[..., 0], 255,
                                          header=b"P2 #c\n7 9\n#d\n255\n"),
    "sun24_17x23.ras": lambda: cv2.imencode(".ras", R.demo(17, 23)[..., ::-1].copy())[1]
    .tobytes(),
    "sun8_cmap_13x21.ras": lambda: R.sunras(np.random.RandomState(2).randint(0, 256, (13, 21)),
                                            8, cmap=np.random.RandomState(3).randint(0, 256,
                                                                                     (3, 256))),
    "sun1_cmap_9x11.ras": lambda: R.sunras(np.random.RandomState(4).randint(0, 2, (9, 11)), 1,
                                           cmap=[[9, 200], [30, 100], [250, 0]]),
}


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("size", R.SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_matches_cv2(size, tmp_path, monkeypatch):
    from hi3d_tpu_torch.utils.pnm import decode_pnm
    from hi3d_tpu_torch.utils.sunras import decode_sunras

    R.hide_cv2(monkeypatch)
    for decode, variants in ((decode_pnm, pnm_variants), (decode_sunras, sun_variants)):
        for k, (label, blob) in enumerate(variants(*size, seed=size[0])):
            path = str(tmp_path / f"{k}.img") if size[0] <= 100 else None
            R.same_as_cv2(blob, decode, f"{label} {size}", path)


def test_fixtures_decode_to_their_goldens(monkeypatch):
    from hi3d_tpu_torch.utils.image import read_image

    R.hide_cv2(monkeypatch)
    assert R.check_fixtures(FIXTURE_DIR, FIXTURES, read_image) < 20_000


def test_sixteen_bit_pnms_raise_with_or_without_cv2(monkeypatch, tmp_path):
    """cv2 returns uint16 for maxval > 255, which the JAX package's / 255
    mishandles: a ValueError (not `Unsupported`, so no cv2 read) on every
    host, through every reader."""
    from hi3d_tpu_torch.utils.image import decode_image, load_image_rgb, read_image
    from hi3d_tpu_torch.utils.raster import Unsupported

    blob = cv2.imencode(".pgm", (R.demo(5, 7)[..., 0].astype(np.uint16) * 257))[1].tobytes()
    assert R.cv2_rgb(blob).dtype == np.uint16
    path = str(tmp_path / "x.pgm")
    with open(path, "wb") as f:
        f.write(blob)
    for hidden in (False, True):
        if hidden:
            R.hide_cv2(monkeypatch)
        for call in (lambda: decode_image(blob, path), lambda: read_image(path),
                     lambda: load_image_rgb(path)):
            with pytest.raises(ValueError, match="16-bit PNM") as e:
                call()
            assert not isinstance(e.value, Unsupported)


def test_refusals_name_the_variant(monkeypatch):
    """cv2 5.0 decodes no byte-encoded and no RGB-format Sun raster; the
    port refuses them by name (`Unsupported`). PAM (P7), which it refused
    as a format it did not decode, now decodes as cv2 decodes it
    (utils/pam.py; tests/test_torch_pam.py), and cv2's RGBA PAM, which cv2
    refuses, raises a ValueError that names it."""
    from hi3d_tpu_torch.utils.image import decode_image
    from hi3d_tpu_torch.utils.raster import Unsupported
    from hi3d_tpu_torch.utils.sunras import decode_sunras

    R.hide_cv2(monkeypatch)
    img = R.demo(5, 6)[..., ::-1]
    for kind, match in ((2, "byte-encoded"), (3, "RGB-format")):
        blob = R.sunras(img, 24, kind=kind)
        assert R.cv2_rgb(blob) is None
        with pytest.raises(Unsupported, match=match):
            decode_sunras(blob, "x.ras")
    pam = cv2.imencode(".pam", img.copy())[1].tobytes()
    np.testing.assert_array_equal(decode_image(pam, "x.pam"), R.cv2_rgb(pam))
    rgba = cv2.imencode(".pam", np.concatenate([img, img[..., :1]], -1))[1].tobytes()
    assert R.cv2_rgb(rgba) is None
    with pytest.raises(ValueError, match="x.pam: a PAM of depth 4 without a TUPLTYPE"):
        decode_image(rgba, "x.pam")


@pytest.mark.parametrize("kind", ["p6", "p3", "p4", "sun24", "sun8_cmap"])
def test_damaged_files_raise_or_match_cv2(kind):
    from hi3d_tpu_torch.utils.pnm import decode_pnm
    from hi3d_tpu_torch.utils.sunras import decode_sunras

    name = {"p6": "p6_17x23.ppm", "p3": "p3_maxval15_7x9.ppm", "p4": "p4_13x21.pbm",
            "sun24": "sun24_17x23.ras", "sun8_cmap": "sun8_cmap_13x21.ras"}[kind]
    decode = decode_sunras if kind.startswith("sun") else decode_pnm
    counts = R.damaged(FIXTURES[name](), decode, seed=len(name), flips=300)
    assert sum(counts.values()) > 300


if __name__ == "__main__":
    R.write_fixtures(FIXTURE_DIR, FIXTURES)
