"""The port's BMP decoder (hi3d_tpu_torch/utils/bmp.py) against cv2's
`imdecode(..., IMREAD_UNCHANGED)` (OpenCV's own BmpDecoder), bit for bit,
with cv2 hidden from the port: files from cv2 (24 bits, 32 bits with
alpha in a V5 header, 8-bit grey) and PIL (1, L, P, RGB, RGBA) at sizes
1×1 to 389×517, and hand-built ones (tests/torch_raster.py) for every
header (core, INFO, V4, V5), depth (1, 4, 8, 16, 24, 32), compression
(BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS) and row order; the refusals;
damaged files.

tests/data/torch_bmp/ holds the committed fixtures and goldens.json (shape
and SHA-256 of cv2's decode as RGB(A)); `python tests/test_torch_bmp.py`
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

FIXTURE_DIR = os.path.join(R.ROOT, "tests", "data", "torch_bmp")


def _palette(n, seed, grey=False):
    rnd = np.random.RandomState(seed)
    if grey:
        return np.repeat(rnd.randint(0, 256, (n, 1)), 3, 1)
    return rnd.randint(0, 256, (n, 3))


def _indices(h, w, bits, seed):
    """Indices with runs and a zero stretch (for RLE's encoded runs and
    deltas)."""
    rnd = np.random.RandomState(seed)
    idx = rnd.randint(0, 1 << bits, (h, w))
    idx[:, :w // 3] = rnd.randint(1 << bits)
    idx[h // 2, w // 3:] = 0
    return idx.astype(np.uint8)


def _rgba(h, w, seed=0):
    rgb = R.demo(h, w, seed)
    a = np.random.RandomState(seed).randint(0, 256, (h, w, 1)).astype(np.uint8)
    return np.concatenate([rgb, a], -1)


def _cv2(img, ext=".bmp"):
    return cv2.imencode(ext, img)[1].tobytes()


def _pil(img, mode):
    im = Image.fromarray(img)
    im = im.quantize(13) if mode == "P" else im.convert(mode)
    f = io.BytesIO()
    im.save(f, "BMP")
    return f.getvalue()


def variants(h, w, seed=0):
    """(label, file) for every BMP variant at (h, w)."""
    rgba = _rgba(h, w, seed)
    bgra = rgba[..., [2, 1, 0, 3]]
    out = [("cv2 24", _cv2(bgra[..., :3])), ("cv2 32 V5", _cv2(bgra)),
           ("cv2 grey", _cv2(bgra[..., 0].copy()))]
    out += [(f"PIL {m}", _pil(rgba if m == "RGBA" else rgba[..., :3], m))
            for m in ("1", "L", "P", "RGB", "RGBA")]
    words = np.random.RandomState(seed).randint(0, 65536, (h, w))
    out += [("16 BI_RGB", R.bmp(words, 16)),
            ("16 bitfields 555", R.bmp(words, 16, 3, masks=(0x7C00, 0x3E0, 0x1F))),
            ("16 bitfields 565", R.bmp(words, 16, 3, masks=(0xF800, 0x7E0, 0x1F))),
            ("16 V5 565 masks after the header",
             R.bmp(words, 16, 3, header=124, header_masks=(0xF800, 0x7E0, 0x1F, 0),
                   masks=(0xF800, 0x7E0, 0x1F))),
            ("24 top-down", R.bmp(bgra[..., :3], 24, top_down=True)),
            ("24 V4", R.bmp(bgra[..., :3], 24, header=108)),
            ("24 core", R.bmp(bgra[..., :3], 24, header=12)),
            ("32 BI_RGB", R.bmp(bgra, 32)),
            ("32 bitfields INFO", R.bmp(bgra, 32, 3, masks=(0xFF0000, 0xFF00, 0xFF))),
            ("32 bitfields V4 top-down", R.bmp(bgra, 32, 3, header=108, top_down=True,
                                               header_masks=(0xFF0000, 0xFF00, 0xFF,
                                                             0xFF000000))),
            ("32 core", R.bmp(bgra, 32, header=12))]
    for bits in (1, 4, 8):
        idx = _indices(h, w, bits, seed + bits)
        n = 1 << bits
        out += [(f"{bits} colour", R.bmp(idx, bits, palette=_palette(n, seed))),
                (f"{bits} grey", R.bmp(idx, bits, palette=_palette(n, seed, True))),
                (f"{bits} core", R.bmp(idx, bits, header=12, palette=_palette(n, seed))),
                (f"{bits} top-down short palette",
                 R.bmp(idx, bits, palette=_palette(max(2, n // 2), seed), top_down=True))]
        if bits > 1:
            comp = 1 if bits == 8 else 2
            for k in range(2):
                rle = R.bmp_rle(idx, bits, seed + k)
                out += [(f"RLE{bits} {k}", R.bmp(idx, bits, comp, palette=_palette(n, seed),
                                                 rle=rle)),
                        (f"RLE{bits} grey {k}", R.bmp(idx, bits, comp, rle=rle,
                                                      palette=_palette(n, seed, True)))]
    return out


FIXTURES = {
    "rgb24_17x23.bmp": lambda: _cv2(R.demo(17, 23)[..., ::-1]),
    "rgba32_v5_31x30.bmp": lambda: _cv2(_rgba(31, 30)[..., [2, 1, 0, 3]]),
    "pal4_topdown_7x9.bmp": lambda: R.bmp(_indices(7, 9, 4, 1), 4, palette=_palette(16, 1),
                                          top_down=True),
    "grey8_core_9x7.bmp": lambda: R.bmp(_indices(9, 7, 8, 2), 8, header=12,
                                        palette=_palette(256, 2)),
    "rle8_29x31.bmp": lambda: R.bmp(_indices(29, 31, 8, 3), 8, 1, palette=_palette(256, 3),
                                    rle=R.bmp_rle(_indices(29, 31, 8, 3), 8, 3)),
    "rle4_grey_13x21.bmp": lambda: R.bmp(_indices(13, 21, 4, 4), 4, 2,
                                         palette=_palette(16, 4, True),
                                         rle=R.bmp_rle(_indices(13, 21, 4, 4), 4, 4)),
    "rgb565_11x13.bmp": lambda: R.bmp(np.random.RandomState(5).randint(0, 65536, (11, 13)), 16,
                                      3, masks=(0xF800, 0x7E0, 0x1F)),
}


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("size", R.SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_matches_cv2(size, tmp_path, monkeypatch):
    from hi3d_tpu_torch.utils.bmp import decode_bmp

    R.hide_cv2(monkeypatch)
    for k, (label, blob) in enumerate(variants(*size, seed=size[0])):
        path = str(tmp_path / f"{k}.bmp") if size[0] <= 100 else None
        R.same_as_cv2(blob, decode_bmp, f"{label} {size}", path)


def test_fixtures_decode_to_their_goldens(monkeypatch):
    from hi3d_tpu_torch.utils.bmp import read_bmp
    from hi3d_tpu_torch.utils.image import read_image

    R.hide_cv2(monkeypatch)
    assert R.check_fixtures(FIXTURE_DIR, FIXTURES, read_bmp) < 20_000
    R.check_fixtures(FIXTURE_DIR, FIXTURES, read_image)


def test_refusals_name_the_variant(monkeypatch):
    """What cv2 does not read raises `Unsupported` (cv2 hidden) naming it;
    with cv2 importing, the image entry points hand it to cv2, which fails
    as well."""
    from hi3d_tpu_torch.utils.bmp import decode_bmp
    from hi3d_tpu_torch.utils.image import decode_image
    from hi3d_tpu_torch.utils.raster import Unsupported

    words = np.zeros((3, 5), np.int64)
    cases = [(R.bmp(words, 16, 3, masks=(0xF00, 0xF0, 0xF)), "masks"),
             (R.bmp(words, 16, header=12), "OS/2 BMP of 16 bits"),
             (R.bmp(words, 16, 3, header=124, header_masks=(0xF800, 0x7E0, 0x1F, 0)), "masks"),
             (R.bmp(words.astype(np.uint8), 8, 4, palette=_palette(4, 0)), "compression 4"),
             (R.bmp(words.astype(np.uint8), 2, palette=_palette(4, 0)), "2 bits a pixel"),
             (R.bmp(words.astype(np.uint8), 8, 2, palette=_palette(4, 0)), "compression 2")]
    for blob, match in cases:
        assert R.cv2_rgb(blob) is None
        with pytest.raises(Unsupported, match=match):
            decode_bmp(blob, "x.bmp")
        with pytest.raises(ValueError, match="cv2 cannot decode it either"):
            decode_image(blob, "x.bmp")
        R.hide_cv2(monkeypatch)
        with pytest.raises(Unsupported, match=match):
            decode_image(blob, "x.bmp")
        monkeypatch.undo()


@pytest.mark.parametrize("kind", ["rgb24", "pal8", "rle8", "rle4", "rgba32"])
def test_damaged_files_raise_or_match_cv2(kind):
    """Truncated and byte-flipped files raise a ValueError or give cv2's
    pixels; RLE streams of random escapes too."""
    from hi3d_tpu_torch.utils.bmp import decode_bmp

    idx8, idx4 = _indices(13, 17, 8, 0), _indices(13, 17, 4, 0)
    blob = {"rgb24": _cv2(R.demo(13, 17)[..., ::-1]),
            "rgba32": _cv2(_rgba(13, 17)[..., [2, 1, 0, 3]]),
            "pal8": R.bmp(idx8, 8, palette=_palette(256, 0)),
            "rle8": R.bmp(idx8, 8, 1, palette=_palette(256, 0), rle=R.bmp_rle(idx8, 8)),
            "rle4": R.bmp(idx4, 4, 2, palette=_palette(16, 0), rle=R.bmp_rle(idx4, 4))}[kind]
    counts = R.damaged(blob, decode_bmp, seed=len(blob), flips=300)
    assert sum(counts.values()) > 300
    if kind.startswith("rle"):
        rnd = np.random.RandomState(1)
        bits = int(kind[3])
        for _ in range(1500):  # random escape-heavy streams on tiny images
            h, w = rnd.randint(1, 4), rnd.randint(1, 5)
            arr = bytearray(rnd.randint(0, 256, rnd.randint(1, 8) * 2).astype(np.uint8))
            for i in range(0, len(arr) - 1, 2):
                if rnd.rand() < 0.5:
                    arr[i], arr[i + 1] = 0, rnd.randint(0, 5)
                else:
                    arr[i] = rnd.randint(0, w + 1)
            R.holds(R.bmp(np.zeros((h, w), np.uint8), bits, 1 if bits == 8 else 2,
                          palette=_palette(16, 0), rle=bytes(arr)), decode_bmp, counts)


if __name__ == "__main__":
    R.write_fixtures(FIXTURE_DIR, FIXTURES)
