"""The port's PAM (P7) decoder (hi3d_tpu_torch/utils/pam.py) against cv2's
`imdecode(..., IMREAD_UNCHANGED)` (OpenCV 5.0's PAMDecoder), bit for bit,
with cv2 hidden from the port: cv2's own PAMs (no TUPLTYPE, grey and
colour; each TUPLTYPE it writes) and hand-built ones (GRAYSCALE_ALPHA,
which cv2 does not write; maxval below 255,
maxval 1 read as packed bits, comments, CR line ends, TUPLTYPE repeated,
trailing blanks) at sizes 1×1 to 389×517; what cv2 refuses (its own RGBA
PAM without a TUPLTYPE, a depth its TUPLTYPE does not have, an unknown
TUPLTYPE, a field twice) refused by name; 16-bit PAMs raising on every
host; damaged files.

tests/data/torch_pam/ holds the committed fixtures and goldens.json (shape
and SHA-256 of cv2's decode as RGB(A)); `python tests/test_torch_pam.py`
writes them again.
"""

import os

import numpy as np
import pytest

import torch_threads  # noqa: F401
import cv2
import torch_raster as R
from torch_raster import one_torch_thread  # noqa: F401

FIXTURE_DIR = os.path.join(R.ROOT, "tests", "data", "torch_pam")
TUPLES = ("BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA")


def cv2_pam(img, tuple_type=None):
    """cv2's PAM of an (H, W[, C]) array, with IMWRITE_PAM_TUPLETYPE set
    when `tuple_type` names one."""
    params = [] if tuple_type is None else [cv2.IMWRITE_PAM_TUPLETYPE,
                                            getattr(cv2, f"IMWRITE_PAM_FORMAT_{tuple_type}")]
    ok, buf = cv2.imencode(".pam", np.ascontiguousarray(img), params)
    assert ok
    return buf.tobytes()


def pam(samples, maxval=255, tuple_type=None, depth=None, head=b"P7\n", eol=b"\n",
        extra=b""):
    """A PAM of (H, W, C) `samples` as the file stores them."""
    h, w, c = samples.shape
    fields = [b"WIDTH %d" % w, b"HEIGHT %d" % h, b"DEPTH %d" % (depth or c),
              b"MAXVAL %d" % maxval] + ([b"TUPLTYPE " + tuple_type.encode()]
                                        if tuple_type is not None else [])
    return head + eol.join(fields) + eol + extra + b"ENDHDR" + eol + \
        samples.astype(np.uint8).tobytes()


def variants(h, w, seed=0):
    rgb = R.demo(h, w, seed)
    rnd = np.random.RandomState(seed)
    alpha = rnd.randint(0, 256, (h, w, 1)).astype(np.uint8)
    grey, bgr = rgb[..., :1], rgb[..., ::-1]
    bits = rnd.randint(0, 256, (h, w, 1))
    out = [("cv2 BGR", cv2_pam(bgr)), ("cv2 grey", cv2_pam(grey[..., 0])),
           ("cv2 GRAYSCALE", cv2_pam(grey[..., 0], "GRAYSCALE")),
           ("cv2 BLACKANDWHITE (maxval 255)", cv2_pam(grey[..., 0], "BLACKANDWHITE")),
           ("cv2 RGB", cv2_pam(bgr, "RGB")),
           ("cv2 RGB_ALPHA", cv2_pam(np.concatenate([bgr, alpha], -1), "RGB_ALPHA")),
           ("GRAYSCALE_ALPHA", pam(np.concatenate([grey, alpha], -1), 255, "GRAYSCALE_ALPHA")),
           ("maxval 100, samples past it", pam(rnd.randint(0, 256, (h, w, 3)), 100)),
           ("maxval 0", pam(grey, 0)),
           ("maxval 1: packed bits", pam(bits, 1)),
           ("maxval 1 RGB: packed bits, grey", pam(rnd.randint(0, 256, (h, w, 3)), 1, "RGB")),
           ("BLACKANDWHITE", pam(bits, 1, "BLACKANDWHITE")),
           ("comments, CR line ends", pam(rgb, eol=b"\r", extra=b"# made here\r\r  \r")),
           ("CRLF after P7", pam(rgb, head=b"P7\r\n")),
           ("TUPLTYPE twice, the last counts", pam(grey, extra=b"TUPLTYPE GRAYSCALE\n",
                                                   tuple_type="RGB")),
           ("an empty TUPLTYPE", pam(rgb, extra=b"TUPLTYPE\n")),
           ("blanks around values", b"P7\n  WIDTH\t %d \nHEIGHT %d\t\n\nDEPTH 003\nMAXVAL 255  \n"
            b"TUPLTYPE   RGB  \nENDHDR\n" % (w, h) + rgb.tobytes() + b"trailing bytes")]
    return out


FIXTURES = {
    "bgr_17x23.pam": lambda: cv2_pam(R.demo(17, 23)[..., ::-1]),
    "grey_tt_9x7.pam": lambda: cv2_pam(R.demo(9, 7)[..., 0], "GRAYSCALE"),
    "rgba_tt_13x21.pam": lambda: cv2_pam(np.concatenate(
        [R.demo(13, 21)[..., ::-1], np.random.RandomState(1).randint(0, 256, (13, 21, 1))
         .astype(np.uint8)], -1), "RGB_ALPHA"),
    "grey_alpha_7x9.pam": lambda: pam(np.concatenate(
        [R.demo(7, 9)[..., :1], np.random.RandomState(2).randint(0, 256, (7, 9, 1))
         .astype(np.uint8)], -1), 255, "GRAYSCALE_ALPHA"),
    "bits_13x21.pam": lambda: pam(np.random.RandomState(3).randint(0, 256, (13, 21, 1)), 1),
    "maxval15_comments_7x9.pam": lambda: pam(np.random.RandomState(4).randint(0, 16, (7, 9, 3)),
                                             15, "RGB", extra=b"# maxval 15\n"),
}


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("size", R.SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_matches_cv2(size, tmp_path, monkeypatch):
    """Every variant decodes as cv2 decodes it, through decode_pam,
    decode_image and (up to 100 rows) read_image and load_image_rgb; JAX's
    load_image_rgb, which returns grey + alpha as two channels, is held
    against the port's only for 1, 3 and 4 channels."""
    from hi3d_tpu_torch.utils.pam import decode_pam

    R.hide_cv2(monkeypatch)
    for k, (label, blob) in enumerate(variants(*size, seed=size[0])):
        two = "GRAYSCALE_ALPHA" in label
        path = str(tmp_path / f"{k}.pam") if size[0] <= 100 and not two else None
        R.same_as_cv2(blob, decode_pam, f"{label} {size}", path)


def test_fixtures_decode_to_their_goldens(monkeypatch):
    from hi3d_tpu_torch.utils.image import read_image

    R.hide_cv2(monkeypatch)
    assert R.check_fixtures(FIXTURE_DIR, FIXTURES, read_image) < 10_000


def test_refusals_name_what_cv2_refuses(monkeypatch):
    """What cv2 5.0 refuses, the port refuses with a ValueError that names
    it: cv2's own RGBA PAM (depth 4 and no TUPLTYPE), depth 2 without one, a
    depth its TUPLTYPE does not have, an unknown TUPLTYPE, maxval 1 at depth
    2, a field twice or missing, a number that is not one, P7 followed by a
    blank, a cut file."""
    from hi3d_tpu_torch.utils.image import decode_image
    from hi3d_tpu_torch.utils.raster import Unsupported

    R.hide_cv2(monkeypatch)
    rgba = np.concatenate([R.demo(5, 6)[..., ::-1], np.full((5, 6, 1), 200, np.uint8)], -1)
    grey = R.demo(5, 6)[..., :1]
    cases = [(cv2_pam(rgba), "depth 4 without a TUPLTYPE"),
             (pam(rgba[..., :2]), "depth 2 without a TUPLTYPE"),
             (pam(rgba[..., :3], tuple_type="RGB_ALPHA"), "TUPLTYPE RGB_ALPHA and depth 3"),
             (pam(grey, tuple_type="RGB"), "TUPLTYPE RGB and depth 1"),
             (pam(grey, tuple_type="GREY"), "TUPLTYPE 'GREY'"),
             (pam(grey, tuple_type=""), "TUPLTYPE 'ENDHDR'"),  # its value on the next line
             (pam(rgba[..., :2], 1, "GRAYSCALE_ALPHA"), "maxval 1 and depth 2"),
             (pam(grey, extra=b"WIDTH 6\n"), "WIDTH twice"),
             (b"P7\nWIDTH 6\nHEIGHT 5\nMAXVAL 255\nENDHDR\n" + grey.tobytes(), "without DEPTH"),
             (pam(grey).replace(b"WIDTH 6", b"WIDTH 6px"), "WIDTH of b'6px'"),
             (pam(grey).replace(b"WIDTH 6", b"WIDTH +6"), "WIDTH of b'\\+6'"),
             (pam(grey).replace(b"HEIGHT", b"height"), "header line b'height'"),
             (pam(grey, head=b"P7 \n"), "not followed by a newline"),
             (pam(grey)[:-1], "truncated PAM"),
             (pam(grey)[:20], "truncated PAM header")]
    for blob, match in cases:
        assert R.cv2_rgb(blob) is None, match
        with pytest.raises(ValueError, match="x.pam: .*" + match) as e:
            decode_image(blob, "x.pam")
        assert not isinstance(e.value, Unsupported), match


def test_sixteen_bit_pams_raise_with_or_without_cv2(monkeypatch, tmp_path):
    """maxval above 255: cv2 returns uint16 (with a TUPLTYPE) or nothing,
    and the JAX package's / 255 mishandles uint16; a ValueError (not
    `Unsupported`, so no cv2 read) on every host, through every reader."""
    from hi3d_tpu_torch.utils.image import decode_image, load_image_rgb, read_image
    from hi3d_tpu_torch.utils.raster import Unsupported

    blob = cv2_pam(R.demo(5, 7)[..., 0].astype(np.uint16) * 257, "GRAYSCALE")
    assert R.cv2_rgb(blob).dtype == np.uint16
    path = str(tmp_path / "x.pam")
    with open(path, "wb") as f:
        f.write(blob)
    for hidden in (False, True):
        if hidden:
            R.hide_cv2(monkeypatch)
        for call in (lambda: decode_image(blob, path), lambda: read_image(path),
                     lambda: load_image_rgb(path)):
            with pytest.raises(ValueError, match="16-bit PAM") as e:
                call()
            assert not isinstance(e.value, Unsupported)


@pytest.mark.parametrize("name", ["bgr_17x23.pam", "rgba_tt_13x21.pam", "bits_13x21.pam",
                                  "maxval15_comments_7x9.pam"])
def test_damaged_files_raise_or_match_cv2(name):
    from hi3d_tpu_torch.utils.pam import decode_pam

    counts = R.damaged(FIXTURES[name](), decode_pam, seed=len(name), flips=300)
    assert sum(counts.values()) > 300 and counts["as_cv2"] > 0


if __name__ == "__main__":
    R.write_fixtures(FIXTURE_DIR, FIXTURES)
