"""The port's TIFF decoder (hi3d_tpu_torch/utils/tiff.py) against cv2's
`imdecode(..., IMREAD_UNCHANGED)` (OpenCV's TiffDecoder over libtiff's
RGBA interface), bit for bit, with cv2 hidden from the port: cv2's TIFFs
(none, LZW, Deflate, PackBits and JPEG, with and without the predictor;
RGB, RGBA, grey) and PIL's (unassociated alpha, CMYK, palettes, 1-bit,
grey + alpha, JPEG of RGB, grey, CMYK and YCbCr, multi-page) at sizes 1×1
to 389×517; hand-built ones (tests/torch_raster.py) with strips and tiles,
PlanarConfiguration 2, FillOrder 2, big-endian order, the old LZW form,
MinIsWhite, 1/4/8-bit palettes with 8- or 16-bit colour maps, associated,
unassociated and unspecified alpha, and YCbCr JPEG strips and tiles at
4:2:0, 4:2:2 and 4:4:4 with and without JPEGTables; that libjpeg's fancy
upsampling is what libtiff's RGBA path gets; 16-bit and float TIFFs
raising on every host; the refusals; damaged files.

tests/data/torch_tiff/ holds the committed fixtures and goldens.json (shape
and SHA-256 of cv2's decode as RGB(A)); demo3_lzw_pred2.tif is demo/3.png
as cv2 writes an LZW TIFF with the horizontal predictor (the chip smoke's
main path 5 reads it; path 16 times it and demo3_deflate.tif). `python
tests/test_torch_tiff.py` writes them again.
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

FIXTURE_DIR = os.path.join(R.ROOT, "tests", "data", "torch_tiff")


def _cv2(img, compression=1, predictor=1):
    return cv2.imencode(".tif", np.ascontiguousarray(img),
                        [cv2.IMWRITE_TIFF_COMPRESSION, compression,
                         cv2.IMWRITE_TIFF_PREDICTOR, predictor])[1].tobytes()


def _pil(img, mode, compression=None, **kw):
    f = io.BytesIO()
    im = img if isinstance(img, Image.Image) else Image.fromarray(img, mode)
    im.save(f, "TIFF", **({"compression": compression} if compression else {}), **kw)
    return f.getvalue()


def _alpha(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 1)).astype(np.uint8)


def variants(h, w, seed=0):
    """(label, file) for every TIFF variant at (h, w); the pure-Python LZW
    encoder and the 4:2:2 and 4:4:4 JPEG strips only below 100 × 100
    pixels."""
    rgb = R.demo(h, w, seed)
    rgba = np.concatenate([rgb, _alpha(h, w, seed)], -1)
    bgr, bgra = rgb[..., ::-1], rgba[..., [2, 1, 0, 3]]
    small = h * w <= 10_000
    lzw = 5 if small else 8
    out = []
    for comp in (1, 5, 8, 32946, 32773, 7):
        for pred in ((1, 2) if comp in (5, 8, 32946) else (1,)):
            for label, img in (("RGB", bgr), ("RGBA", bgra), ("grey", rgb[..., 1])):
                blob = _cv2(img, comp, pred)
                if R.cv2_rgb(blob) is not None:  # cv2 writes JPEG strips of 8k rows only
                    out.append((f"cv2 {label} c{comp} p{pred}", blob))
    for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
        out += [(f"PIL RGBA {comp}", _pil(rgba, "RGBA", comp)),
                (f"PIL CMYK {comp}", _pil(rgba, "CMYK", comp)),
                (f"PIL palette {comp}", _pil(Image.fromarray(rgb).quantize(37), None, comp)),
                (f"PIL 1-bit {comp}", _pil(Image.fromarray(rgb).convert("1"), None, comp)),
                (f"PIL grey + alpha {comp}", _pil(rgba[..., 1:3].copy(), "LA", comp))]
    out += [(f"PIL JPEG {mode}", _pil(img, mode, "jpeg"))
            for mode, img in (("RGB", rgb), ("L", rgb[..., 0].copy()), ("CMYK", rgba),
                              ("YCbCr", rgb))]
    pages = [Image.fromarray(np.roll(rgb, k, 1)) for k in range(3)]
    out.append(("PIL three pages", _pil(pages[0], None, "tiff_lzw", save_all=True,
                                        append_images=pages[1:])))
    rnd = np.random.RandomState(seed)
    out += [("strips of 3 rows, LZW, predictor", R.tiff(rgb, 2, 8, lzw, 2, rows_per_strip=3)),
            ("tiles, Deflate, predictor", R.tiff(rgba, 2, 8, 8, 2, tile=(16, 16))),
            ("tiles, PackBits, CMYK", R.tiff(rgba, 5, 8, 32773, tile=(32, 16))),
            ("uncompressed tiles of RGBA", R.tiff(rgba, 2, 8, 1, tile=(16, 16))),
            ("planar RGB, Deflate, strips", R.tiff(rgb, 2, 8, 8, 2, rows_per_strip=4, planar=2)),
            ("planar RGBA unassociated, PackBits", R.tiff(rgba, 2, 8, 32773, planar=2,
                                                          extra_samples=[2])),
            ("planar RGBA associated, tiles", R.tiff(rgba, 2, 8, 8, tile=(16, 16), planar=2,
                                                     extra_samples=[1])),
            ("planar CMYK", R.tiff(rgba, 5, 8, 8, planar=2)),
            ("RGBA unspecified extra sample", R.tiff(rgba, 2, 8, 8, extra_samples=[0])),
            ("big-endian, LZW, predictor", R.tiff(rgb, 2, 8, lzw, 2, big_endian=True)),
            ("FillOrder 2, Deflate", R.tiff(rgb, 2, 8, 8, fill_order=2, rows_per_strip=5)),
            ("MinIsWhite 8-bit", R.tiff(rgb[..., 0], 0, 8, 32773)),
            ("MinIsWhite 1-bit", R.tiff(rnd.randint(0, 2, (h, w)), 0, 1, 8, rows_per_strip=7)),
            ("MinIsBlack 1-bit FillOrder 2", R.tiff(rnd.randint(0, 2, (h, w)), 1, 1, 32773,
                                                    fill_order=2)),
            ("palette 8-bit, 8-bit map", R.tiff(rnd.randint(0, 256, (h, w)), 3, 8, 8,
                                                colormap=rnd.randint(0, 256, (256, 3)))),
            ("palette 4-bit, 16-bit map", R.tiff(rnd.randint(0, 16, (h, w)), 3, 4, 32773,
                                                 colormap=rnd.randint(0, 65536, (16, 3)))),
            ("palette 1-bit (grey in cv2)", R.tiff(rnd.randint(0, 2, (h, w)), 3, 1, 8,
                                                   colormap=rnd.randint(0, 65536, (2, 3))))]
    if small:
        out.append(("old LSB-first LZW", R.tiff(rgba, 2, 8, 5, lzw_style="compat",
                                                rows_per_strip=6)))
    for samp in ("420", "422", "444") if small else ("420",):  # JPEG's host decode is slow
        out += [(f"YCbCr JPEG {samp}, tables", R.tiff(rgb, 6, 8, 7, sampling=samp)),
                (f"YCbCr JPEG {samp} strips of 16, no tables",
                 R.tiff(rgb, 6, 8, 7, sampling=samp, rows_per_strip=16, jpeg_tables=False)),
                (f"YCbCr JPEG {samp} tiles", R.tiff(rgb, 6, 8, 7, sampling=samp,
                                                    tile=(16, 16) if small else (128, 64)))]
    return out


FIXTURES = {
    "demo3_lzw_pred2.tif": lambda: _cv2(cv2.imread(os.path.join(R.ROOT, "demo", "3.png"),
                                                   cv2.IMREAD_UNCHANGED), 5, 2),
    "demo3_deflate.tif": lambda: _cv2(cv2.imread(os.path.join(R.ROOT, "demo", "3.png"),
                                                 cv2.IMREAD_UNCHANGED), 8),
    "rgba_unassoc_deflate_17x23.tif": lambda: _pil(np.concatenate(
        [R.demo(17, 23), _alpha(17, 23, 1)], -1), "RGBA", "tiff_adobe_deflate"),
    "cmyk_packbits_13x21.tif": lambda: _pil(np.concatenate(
        [R.demo(13, 21), _alpha(13, 21, 2)], -1), "CMYK", "packbits"),
    "ycbcr420_jpeg_tiles_31x30.tif": lambda: R.tiff(R.demo(31, 30), 6, 8, 7, tile=(16, 16)),
    "palette4_packbits_be_9x11.tif": lambda: R.tiff(
        np.random.RandomState(3).randint(0, 16, (9, 11)), 3, 4, 32773, big_endian=True,
        colormap=np.random.RandomState(4).randint(0, 65536, (16, 3))),
    "minwhite1_lzw_compat_7x9.tif": lambda: R.tiff(
        np.random.RandomState(5).randint(0, 2, (7, 9)), 0, 1, 5, lzw_style="compat"),
}


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("size", R.SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_matches_cv2(size, tmp_path, monkeypatch):
    from hi3d_tpu_torch.utils.tiff import decode_tiff

    R.hide_cv2(monkeypatch)
    for k, (label, blob) in enumerate(variants(*size, seed=size[0])):
        path = str(tmp_path / f"{k}.tif") if size[0] <= 100 else None
        R.same_as_cv2(blob, decode_tiff, f"{label} {size}", path)


def test_ycbcr_jpeg_takes_libjpegs_fancy_upsampling(monkeypatch):
    """libtiff's RGBA path has libjpeg convert YCbCr to RGB with its default
    fancy upsampling: replication instead (do_fancy_upsampling off, which
    the merged upsampler matches) is many levels off cv2."""
    from hi3d_tpu_torch.utils import jpeg, tiff

    blob = R.tiff(R.demo(45, 61), 6, 8, 7, sampling="420")
    want = R.cv2_rgb(blob)
    np.testing.assert_array_equal(tiff.decode_tiff(blob), want)
    monkeypatch.setattr(jpeg, "upsample", lambda p, ratio, h, w: p.repeat_interleave(
        ratio[1], dim=-2).repeat_interleave(ratio[0], dim=-1)[:, :h, :w])
    assert np.abs(tiff.decode_tiff(blob).astype(int) - want).max() > 8


def test_fixtures_decode_to_their_goldens(monkeypatch):
    from hi3d_tpu_torch.utils.image import read_image
    from hi3d_tpu_torch.utils.tiff import read_tiff

    R.hide_cv2(monkeypatch)
    assert R.check_fixtures(FIXTURE_DIR, FIXTURES, read_tiff) < 150_000
    R.check_fixtures(FIXTURE_DIR, FIXTURES, read_image)
    png = cv2.imread(os.path.join(R.ROOT, "demo", "3.png"), cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(read_tiff(os.path.join(FIXTURE_DIR, "demo3_lzw_pred2.tif")),
                                  png)


def test_deep_tiffs_raise_with_or_without_cv2(monkeypatch, tmp_path):
    """16-bit and float TIFFs come back from cv2 as uint16 and float32,
    which the JAX package's / 255 mishandles: a ValueError (no cv2 read)
    on every host, through every reader."""
    from hi3d_tpu_torch.utils.image import decode_image, load_image_rgb, read_image
    from hi3d_tpu_torch.utils.raster import Unsupported

    deep = [(cv2.imencode(".tif", R.demo(5, 7).astype(np.uint16) * 257)[1].tobytes(), "16-bit"),
            (_pil(R.demo(5, 7)[..., 0].astype(np.float32), "F"), "float")]
    for k, (blob, match) in enumerate(deep):
        path = str(tmp_path / f"{k}.tif")
        with open(path, "wb") as f:
            f.write(blob)
        for hidden in (False, True):
            if hidden:
                R.hide_cv2(monkeypatch)
            for call in (lambda: decode_image(blob, path), lambda: read_image(path),
                         lambda: load_image_rgb(path)):
                with pytest.raises(ValueError, match=f"a {match} TIFF") as e:
                    call()
                assert not isinstance(e.value, Unsupported)
            monkeypatch.undo()


def test_refusals_name_the_variant(monkeypatch):
    """Variants the port does not decode raise `Unsupported` naming them with
    cv2 hidden, and decode as cv2 decodes them where it imports."""
    from hi3d_tpu_torch.utils.image import decode_image
    from hi3d_tpu_torch.utils.raster import Unsupported
    from hi3d_tpu_torch.utils.tiff import decode_tiff

    rgb = R.demo(16, 16)
    rgba = np.concatenate([rgb, _alpha(16, 16, 0)], -1)
    cases = [(_pil(Image.fromarray(rgb).convert("1"), None, "group4"), "CCITT G4"),
             (b"II+\x00" + bytes(12), "BigTIFF"),
             (R.tiff(rgb, 2, 8, 6), "old-style JPEG"),
             (R.tiff(rgb[..., 0] // 64, 1, 2, 8), "2 bits"),
             (_pil(rgb, "YCbCr"), "YCbCr TIFF not compressed as JPEG"),
             (R.tiff(rgb, 2, 8, 8, extra_tags={274: (3, [3])}), "Orientation 3"),
             (R.tiff(rgba[..., 1:3], 1, 8, 8, tile=(16, 16), extra_samples=[2]), "or tiled"),
             (R.tiff(rgb, 2, 8, 8, extra_tags={339: (3, [2, 2, 2])}), "SampleFormat 2")]
    for blob, match in cases:
        with pytest.raises(Unsupported, match=match):
            decode_tiff(blob, "x.tif")
        want = R.cv2_rgb(blob)
        if want is not None and want.dtype == np.uint8:
            np.testing.assert_array_equal(decode_image(blob, "x.tif"), want)
        R.hide_cv2(monkeypatch)
        with pytest.raises(Unsupported, match=match):
            decode_image(blob, "x.tif")
        monkeypatch.undo()


@pytest.mark.parametrize("kind", ["lzw_pred", "deflate_rgba", "packbits_cmyk", "jpeg_tiles",
                                  "planar_palette"])
def test_damaged_files_raise_or_match_cv2(kind):
    from hi3d_tpu_torch.utils.tiff import decode_tiff

    rgb = R.demo(13, 17)
    rgba = np.concatenate([rgb, _alpha(13, 17, 0)], -1)
    blob = {"lzw_pred": _cv2(rgb[..., ::-1], 5, 2),
            "deflate_rgba": _pil(rgba, "RGBA", "tiff_adobe_deflate"),
            "packbits_cmyk": R.tiff(rgba, 5, 8, 32773, rows_per_strip=4),
            "jpeg_tiles": R.tiff(rgb, 6, 8, 7, tile=(16, 16)),
            "planar_palette": R.tiff(rgba, 2, 8, 8, planar=2, extra_samples=[2])}[kind]
    counts = R.damaged(blob, decode_tiff, seed=len(blob), flips=300)
    assert sum(counts.values()) > 300


if __name__ == "__main__":
    R.write_fixtures(FIXTURE_DIR, FIXTURES)
