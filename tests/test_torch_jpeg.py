"""The port's JPEG decoder (hi3d_tpu_torch/utils/jpeg.py) against cv2's
`imdecode(..., IMREAD_UNCHANGED)` (OpenCV's libjpeg-turbo), bit for bit, on
JPEGs that cv2 encodes: qualities 10–100, 4:4:4, 4:2:2, 4:2:0, 4:1:1 and
4:4:0 chroma, grey, restart intervals, sequential and progressive, sizes
from 1×1 to 517×389; on PIL's progressive, CMYK (Adobe-inverted) and
RGB-coded JPEGs; progressive files cut before their last refinement,
which libjpeg-turbo block-smooths (DC only, some AC bands unrefined, a scan
cut in the middle); the formats it refuses; the readers that take JPEGs
now (load_image_rgb, the folder and tar datasets, serve's input glob); and
the new modules with jax, cv2 and PIL blocked.

tests/data/torch_jpeg/ holds the committed fixtures (the chip smoke decodes
them on a machine without cv2) and goldens.json, the shape and SHA-256 of
cv2's decode of each. `python tests/test_torch_jpeg.py` writes them again
from demo/3.png with `FIXTURES`' settings.
"""

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401
import cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "torch_jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
# name: (height, width, quality, sampling or "gray" (cv2) or a PIL mode, restart
# interval, progressive[, the scans kept: a whole number of them, and of the
# next a fraction of its bytes, the file then ended with EOI])
FIXTURES = {
    "demo3_q90.jpg": (512, 512, 90, "420", 0, False),
    "demo3_q30_rst1_389x517.jpg": (389, 517, 30, "420", 1, False),
    "c444_q95_17x33.jpg": (17, 33, 95, "444", 0, False),
    "c422_q50_rst2_31x45.jpg": (31, 45, 50, "422", 2, False),
    "c420_q10_3x5.jpg": (3, 5, 10, "420", 0, False),
    "c420_q100_1x1.jpg": (1, 1, 100, "420", 0, False),
    "gray_q75_29x37.jpg": (29, 37, 75, "gray", 0, False),
    "prog_q85_rst3_389x517.jpg": (389, 517, 85, "420", 3, True),
    "prog_gray_q70_61x45.jpg": (61, 45, 70, "gray", 0, True),
    "c411_q75_29x61.jpg": (29, 61, 75, "411", 0, False),
    "c440_q60_45x31.jpg": (45, 31, 60, "440", 0, True),
    "pil_prog_q80_45x61.jpg": (45, 61, 80, "RGB", 0, True),
    "pil_cmyk_q85_40x56.jpg": (40, 56, 85, "CMYK", 0, False),
    "pil_rgb_q90_33x17.jpg": (33, 17, 90, "keep_rgb", 0, False),
    # main path 4's first serve input: demo/3.png itself, progressive
    "asset0.jpg": (512, 512, 90, "420", 0, True),
    # progressive files libjpeg-turbo block-smooths: demo/3.png after its DC
    # scan alone (the 5×5 DC interpolation) and after 5 of its 10 scans
    "smooth_dc_512.jpg": (512, 512, 90, "420", 0, True, 1),
    "smooth_q90_512.jpg": (512, 512, 90, "420", 0, True, 5),
    "smooth_cut_rst2_37x53.jpg": (37, 53, 75, "420", 2, True, 5.5),
    "smooth_gray_61x45.jpg": (61, 45, 70, "gray", 0, True, 3),
    "smooth_440_45x31.jpg": (45, 31, 60, "440", 0, True, 4.3),
    "smooth_pil_45x61.jpg": (45, 61, 80, "RGB", 0, True, 2.5),
}


def _demo(h, w, seed=0):
    """demo/3.png at (h, w) with a little seeded noise (so that the high
    frequencies carry data)."""
    img = cv2.imread(os.path.join(ROOT, "demo", "3.png"), cv2.IMREAD_COLOR)
    if (h, w) != img.shape[:2]:
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    noise = np.random.RandomState(seed).randint(-12, 13, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def encode(img, quality, sampling, restart=0, progressive=False):
    """cv2's JPEG of a BGR (or grey) image."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if sampling != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def encode_pil(img, quality, mode, progressive=False):
    """PIL's JPEG of a BGR image as `mode`: "RGB", "L", "CMYK" (Adobe
    marker, inverted inks) or "keep_rgb" (RGB-coded, Adobe transform 0)."""
    from PIL import Image

    im = Image.fromarray(np.ascontiguousarray(img[..., ::-1]))
    extra = {"keep_rgb": True} if mode == "keep_rgb" else {}
    if mode in ("L", "CMYK"):
        im = im.convert(mode)
    out = io.BytesIO()
    im.save(out, "JPEG", quality=quality, progressive=progressive, **extra)
    return out.getvalue()


def make_fixture(name):
    h, w, q, sampling, rst, prog = FIXTURES[name][:6]
    if name == "asset0.jpg" or (name.startswith("smooth_") and h == 512):  # demo/3.png
        img = cv2.imread(os.path.join(ROOT, "demo", "3.png"), cv2.IMREAD_COLOR)
    else:
        img = _demo(h, w)
    if sampling in ("RGB", "CMYK", "keep_rgb"):
        blob = encode_pil(img, q, sampling, prog)
    else:
        blob = encode(img[..., 1] if sampling == "gray" else img, q, sampling, rst, prog)
    return _cut_scans(blob, *FIXTURES[name][6:])


def cv2_rgb(blob):
    """cv2's decode in the port's layout: RGB, a grey image as (H, W, 1)."""
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    return np.ascontiguousarray(want[..., None] if want.ndim == 2 else want[..., ::-1])


def golden(img):
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def write_fixtures():
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    goldens = {}
    for name in FIXTURES:
        blob = make_fixture(name)
        with open(os.path.join(FIXTURE_DIR, name), "wb") as f:
            f.write(blob)
        goldens[name] = golden(cv2_rgb(blob))
    with open(os.path.join(FIXTURE_DIR, "goldens.json"), "w") as f:
        json.dump(goldens, f, indent=1, sort_keys=True)


SIZES = [(1, 1), (2, 3), (5, 4), (7, 9), (8, 8), (16, 16), (17, 33), (31, 30), (389, 517)]


@pytest.mark.parametrize("sampling", ["444", "422", "420", "411", "440", "gray"])
@pytest.mark.parametrize("restart", [0, 3])
def test_decode_matches_cv2(sampling, restart):
    """Bit-equal to cv2 across qualities 10–100 and sizes 1×1 to 517×389."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg

    for i, (h, w) in enumerate(SIZES):
        for q in ((10, 30, 50, 75, 90, 100) if h < 100 else (10, 85)):
            img = _demo(h, w, seed=i)
            blob = encode(img[..., 0] if sampling == "gray" else img, q, sampling, restart)
            got = decode_jpeg(blob)
            want = cv2_rgb(blob)
            assert got.dtype == np.uint8 and got.shape == want.shape, (h, w, q)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} q{q}")


@pytest.mark.parametrize("sampling", ["444", "422", "420", "411", "440", "gray"])
@pytest.mark.parametrize("restart", [0, 2])
def test_progressive_matches_cv2(sampling, restart):
    """Progressive JPEGs (libjpeg's scan script: DC first and refinement,
    AC first with EOB runs, AC refinement, components in their own block
    grids), with and without restarts: bit-equal to cv2."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg

    for i, (h, w) in enumerate(SIZES):
        for q in ((10, 60, 100) if h < 100 else (85,)):
            img = _demo(h, w, seed=i)
            blob = encode(img[..., 0] if sampling == "gray" else img, q, sampling, restart, True)
            assert b"\xff\xc2" in blob
            np.testing.assert_array_equal(decode_jpeg(blob), cv2_rgb(blob),
                                          err_msg=f"{h}x{w} q{q}")


SMOOTH_SIZES = [(1, 1), (8, 8), (9, 17), (17, 33), (37, 53), (64, 80), (130, 100)]


@pytest.mark.parametrize("sampling", ["444", "422", "420", "411", "440", "gray"])
@pytest.mark.parametrize("restart", [0, 2])
def test_smoothed_progressive_matches_cv2(sampling, restart, tmp_path):
    """Progressive files cut before their last refinement, which
    libjpeg-turbo block-smooths (jdcoefct.c decompress_smooth_data): after
    each of their scans and in the middle of each (EOI appended, as
    `cv2.imdecode` reads them), and cut in the middle of a scan without EOI
    (as `cv2.imread` reads a file): bit-equal to cv2. The DC-only files take
    the 5×5 DC interpolation, the others the AC estimates."""
    from hi3d_tpu_torch.utils import jpeg

    path = str(tmp_path / "cut.jpg")
    smoothed = 0
    for i, (h, w) in enumerate(SMOOTH_SIZES):
        img = _demo(h, w, seed=i)
        blob = encode(img[..., 0] if sampling == "gray" else img, 30 + 10 * i, sampling,
                      restart, True)
        scans = blob.count(b"\xff\xda")
        for cut in [n + f for n in range(scans - 1) for f in (0.0, 0.5)]:
            part = _cut_scans(blob, cut + 1)
            np.testing.assert_array_equal(jpeg.decode_jpeg(part), cv2_rgb(part),
                                          err_msg=f"{h}x{w} {cut + 1} scans")
            with open(path, "wb") as f:
                f.write(part[:-2])
            want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            want = want[..., None] if want.ndim == 2 else want[..., ::-1]
            np.testing.assert_array_equal(jpeg.read_jpeg(path), want,
                                          err_msg=f"{h}x{w} {cut + 1} scans, no EOI")
            smoothed += 1
    assert smoothed > 50


@pytest.mark.parametrize("mode,progressive", [("RGB", True), ("L", True), ("CMYK", False),
                                              ("CMYK", True), ("keep_rgb", False),
                                              ("keep_rgb", True)])
def test_pil_jpegs_match_cv2(mode, progressive):
    """PIL's progressive colour and grey JPEGs, its CMYK JPEGs (4
    components, an Adobe marker, inverted inks: cv2 converts them to BGR
    itself) and its RGB-coded ones (Adobe transform 0: no colour
    transform): bit-equal to cv2."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg

    for i, (h, w) in enumerate(SIZES):
        for q in ((10, 80) if h < 100 else (75,)):
            blob = encode_pil(_demo(h, w, seed=i), q, mode, progressive)
            got = decode_jpeg(blob)
            assert got.shape == (h, w, 1 if mode == "L" else 3)
            np.testing.assert_array_equal(got, cv2_rgb(blob), err_msg=f"{h}x{w} q{q}")


def test_fixtures_decode_to_their_goldens():
    """The committed fixtures: the port's decode and cv2's give the goldens'
    bytes."""
    from hi3d_tpu_torch.utils.jpeg import read_jpeg

    with open(os.path.join(FIXTURE_DIR, "goldens.json")) as f:
        goldens = json.load(f)
    assert set(goldens) == set(FIXTURES)
    total = 0
    for name, want in goldens.items():
        path = os.path.join(FIXTURE_DIR, name)
        total += os.path.getsize(path)
        with open(path, "rb") as f:
            assert golden(cv2_rgb(f.read())) == want, name
        assert golden(read_jpeg(path)) == want, name
    assert total < 300_000


def test_smoothed_fixtures_are_smoothed(monkeypatch):
    """Each smooth_* fixture decodes through the block smoothing, every
    component of it (the chip smoke times smooth_q90_512.jpg as the 512²
    smoothed JPEG), and not to what its coefficients give unsmoothed."""
    from hi3d_tpu_torch.utils import jpeg

    real = jpeg._smoothed
    names = [n for n in FIXTURES if n.startswith("smooth_")]
    assert len(names) == 6
    for name in names:
        path, calls = os.path.join(FIXTURE_DIR, name), []
        with monkeypatch.context() as m:
            m.setattr(jpeg, "_smoothed", lambda fr, c, t: calls.append(c["id"]) or real(fr, c, t))
            got = jpeg.read_jpeg(path)
        with monkeypatch.context() as m:
            m.setattr(jpeg, "_needs_smoothing", lambda fr: False)
            plain = jpeg.read_jpeg(path)
        assert len(calls) == (1 if "gray" in name else 3), name
        assert not np.array_equal(plain, got), name


def _patched(blob, marker, offset, value):
    i = blob.index(marker)
    return blob[:i + offset] + bytes([value]) + blob[i + offset + 1:]


def _first_scans(blob, n):
    """A progressive JPEG cut after its first `n` scans (EOI appended)."""
    starts = [i for i in range(len(blob) - 1) if blob[i:i + 2] == b"\xff\xda"]
    return blob[:starts[n]] + b"\xff\xd9"


def _cut_scans(blob, scans=None):
    """`blob` cut after int(scans) scans and `scans` % 1 of the next one's
    entropy-coded bytes, EOI appended; None keeps it whole."""
    if scans is None:
        return blob
    starts = [i for i in range(len(blob) - 1) if blob[i:i + 2] == b"\xff\xda"]
    n = int(scans)
    if n == scans:
        return blob[:starts[n]] + b"\xff\xd9"
    data = starts[n] + 2 + int.from_bytes(blob[starts[n] + 2:starts[n] + 4], "big")
    end = data  # the first marker after the scan's data that is no RSTn
    while not (blob[end] == 0xFF and blob[end + 1] not in b"\x00\xd0\xd1\xd2\xd3\xd4\xd5\xd6\xd7"):
        end += 1
    return blob[:data + int((scans - n) * (end - data))] + b"\xff\xd9"


def test_unsupported_jpegs_raise():
    """Arithmetic-coded (SOF9), lossless (SOF3), hierarchical (SOF5),
    12-bit, YCCK (Adobe transform 2) and fractionally sampled files raise a
    ValueError that names the format; so do bytes that are no JPEG. The
    whole progressive file decodes, and so does one whose coefficients end
    unrefined, block-smoothed as libjpeg-turbo smooths it."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg

    img = _demo(24, 40)
    prog = encode(img, 75, "420", 0, True)
    np.testing.assert_array_equal(decode_jpeg(prog), cv2_rgb(prog))
    np.testing.assert_array_equal(decode_jpeg(_first_scans(prog, 2)),
                                  cv2_rgb(_first_scans(prog, 2)))
    base = encode(img, 80, "420")
    for sof, what in [(0xC9, "arithmetic-coded JPEG"), (0xC3, "lossless JPEG"),
                      (0xC5, "hierarchical JPEG")]:
        with pytest.raises(ValueError, match=what):
            decode_jpeg(_patched(base, b"\xff\xc0", 1, sof))
    with pytest.raises(ValueError, match="12-bit JPEG"):
        decode_jpeg(_patched(base, b"\xff\xc0", 4, 12))
    cmyk = encode_pil(img, 80, "CMYK")
    with pytest.raises(ValueError, match="YCCK JPEG"):
        decode_jpeg(_patched(cmyk, b"Adobe", 11, 2))
    with pytest.raises(ValueError, match="fractional sampling"):
        decode_jpeg(_patched(_patched(base, b"\xff\xc0", 11, 0x32), b"\xff\xc0", 14, 0x22))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="x.jpg: .*without a frame"):
        decode_jpeg(b"\xff\xd8\xff\xd9", "x.jpg")


def _damaged(blob, rnd):
    """(label, bytes) of `blob` damaged: cut at random points with and
    without an EOI after, bytes of its scans changed, a restart marker
    dropped, renumbered or after garbage."""
    sos = blob.index(b"\xff\xda")
    out = []
    for _ in range(4):
        cut = rnd.randint(sos + 10, len(blob) - 2)
        out += [(f"cut at {cut}", blob[:cut]), (f"cut at {cut} + EOI", blob[:cut] + b"\xff\xd9")]
    for _ in range(6):
        bad = bytearray(blob)
        for _ in range(rnd.randint(1, 4)):
            bad[rnd.randint(sos + 12, len(bad) - 2)] = rnd.randint(256)
        out.append(("bytes changed", bytes(bad)))
    rst = [i for i in range(sos, len(blob) - 1)
           if blob[i] == 0xFF and 0xD0 <= blob[i + 1] <= 0xD7]
    if rst:
        i = rst[len(rst) // 2]
        out += [("a restart dropped", blob[:i] + blob[i + 2:]),
                ("a restart renumbered", blob[:i + 1] + bytes([0xD0 + (blob[i + 1] + 3) % 8])
                 + blob[i + 2:]),
                ("garbage before a restart", blob[:i] + b"\x12\x34\xff\x00" + blob[i:])]
    return out


@pytest.mark.parametrize("progressive", [False, True])
def test_damaged_jpegs_decode_as_cv2(tmp_path, progressive):
    """Damaged files decode as cv2 decodes them, or raise where it fails:
    bytes as `cv2.imdecode` (a cut file raises), a file as `cv2.imread`
    (libjpeg's source ends it with EOI, the rest of a cut scan reads as
    zeros, the rest of its restart interval stays zero); restart markers
    out of order resynchronise as libjpeg does; changed bytes (codes no
    table holds, runs past the block, coefficients past libjpeg-turbo's
    16-bit SIMD lanes, unknown markers) decode alike. A progressive file
    cut before its refinement is block-smoothed as libjpeg-turbo smooths
    it, the rows its last scan's data missed with the bits of the scans
    before."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg

    rnd = np.random.RandomState(int(progressive))
    path = str(tmp_path / "damaged.jpg")
    seen = {"equal": 0, "both fail": 0}
    for (h, w), sampling, restart in [((37, 53), "420", 0), ((64, 80), "420", 2),
                                      ((17, 9), "gray", 1), ((40, 24), "444", 3)]:
        img = _demo(h, w, seed=h)
        blob = encode(img[..., 0] if sampling == "gray" else img, 75, sampling, restart,
                      progressive)
        for label, bad in _damaged(blob, rnd):
            with open(path, "wb") as f:
                f.write(bad)
            for want, read in [(cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_UNCHANGED),
                                lambda: decode_jpeg(bad)),
                               (cv2.imread(path, cv2.IMREAD_UNCHANGED), lambda: read_jpeg(path))]:
                try:
                    got = read()
                except ValueError as e:
                    assert want is None, (h, w, label, e)
                    seen["both fail"] += 1
                    continue
                assert want is not None, (h, w, label, "cv2 fails")
                want = want[..., None] if want.ndim == 2 else want[..., ::-1]
                np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {label}")
                seen["equal"] += 1
    assert seen["equal"] > 30 and seen["both fail"] > 10, seen


def _fixture(name):
    with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
        return f.read()


# (marker, byte offset from its 0xFF, new value, the error it must raise)
MALFORMED = [
    (b"\xff\xda", 4, 5, "a scan of 5 components in a frame of 3"),
    (b"\xff\xda", 4, 255, "a scan of 255 components"),
    (b"\xff\xda", 4, 0, "a scan of 0 components"),
    (b"\xff\xda", 6, 0xF0, r"Huffman tables 15 \(DC\) and 0 \(AC\)"),
    (b"\xff\xda", 6, 0x0F, r"Huffman tables 0 \(DC\) and 15 \(AC\)"),
    (b"\xff\xda", 7, 1, "names component 1 twice"),
    (b"\xff\xc4", 4, 0x0F, "class 0 and id 15"),
    (b"\xff\xc4", 4, 0x20, "class 2 and id 0"),
    (b"\xff\xc4", 20, 255, "Huffman table of 267 codes"),
    (b"\xff\xc4", 3, 18, "truncated Huffman table"),
    (b"\xff\xc0", 11, 0x05, "sampled 0x5"),
    (b"\xff\xc0", 11, 0x51, "sampled 5x1"),
    (b"\xff\xc0", 12, 9, "quantisation table 9"),
    (b"\xff\xc0", 13, 1, "names component 1 twice"),
    (b"\xff\xdb", 4, 0x07, "precision 0 and id 7"),
    (b"\xff\xdb", 2, 0xFF, "truncated JPEG: its 0xFFDB segment"),
]


# a progressive file's first scan (DC first of 3 components): Ss at 11, Se
# at 12, Ah/Al at 13 bytes from its 0xFF
MALFORMED += [
    (b"\xff\xda", 12, 5, "progressive scan with impossible parameters Ss=0, Se=5"),
    (b"\xff\xda", 13, 0x15, "impossible parameters Ss=0, Se=0, Ah=1, Al=5"),
    (b"\xff\xda", 13, 0x0E, "impossible parameters .*Al=14"),
    (b"\xff\xda", 11, 1, "impossible parameters Ss=1, Se=0"),
]


@pytest.mark.parametrize("marker,offset,value,match", MALFORMED)
def test_malformed_headers_raise(marker, offset, value, match):
    """A header byte out of range (a scan's component count or table ids, a
    Huffman table's class, id or size, sampling factors, repeated component
    ids, segment lengths) raises a ValueError naming the file before any of
    it reaches the C decoder."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg

    blob = _fixture("prog_q85_rst3_389x517.jpg" if "progressive" in match or "impossible" in match
                    else "c422_q50_rst2_31x45.jpg")
    with pytest.raises(ValueError, match=f"bad.jpg: .*{match}"):
        decode_jpeg(_patched(blob, marker, offset, value), "bad.jpg")


def test_scan_decoder_checks_its_arguments():
    """The C entry points refuse a component count, table id, sampling or
    block grid outside its arrays, and the progressive one a spectral band
    or successive approximation jdphuff.c refuses (its second guard behind
    the header checks), and write nothing."""
    import ctypes

    from hi3d_tpu_torch.utils.jpeg import _native

    lib = _native()
    coef = np.zeros((2, 2, 64), np.int16)
    ptrs = (ctypes.c_void_p * 5)(*[coef.ctypes.data] * 5)
    bits, vals = np.zeros((8, 17), np.uint8), np.zeros((8, 256), np.uint8)
    data = np.zeros(16, np.uint8)
    end = ctypes.c_long(0)
    last = ctypes.c_long(0)

    def call(ncomp, row, mcus=(2, 2)):
        desc = np.array([row] * max(ncomp, 1), np.int32)
        return lib.hi3d_jpeg_decode_scan(data.ctypes.data, data.size, ctypes.byref(end),
                                         ctypes.byref(last), ncomp,
                                         desc.ctypes.data, ptrs, bits.ctypes.data,
                                         vals.ctypes.data, mcus[0], mcus[1], 0)

    good = [1, 1, 0, 0, 2, 2]
    assert call(1, good) == -4  # the arguments pass; the empty tables do not
    for ncomp, row, mcus in [(5, good, (2, 2)), (0, good, (2, 2)),
                             (1, [1, 1, 15, 0, 2, 2], (2, 2)), (1, [1, 1, 0, 15, 2, 2], (2, 2)),
                             (1, [0, 1, 0, 0, 2, 2], (2, 2)), (1, [1, 5, 0, 0, 2, 2], (2, 2)),
                             (1, good, (3, 2)), (1, good, (2, 3)), (1, good, (-1, 2))]:
        assert call(ncomp, row, mcus) == -5, (ncomp, row, mcus)

    def progressive(ncomp, band):
        desc = np.array([good] * ncomp, np.int32)
        return lib.hi3d_jpeg_decode_progressive(
            data.ctypes.data, data.size, ctypes.byref(end), ctypes.byref(last), ncomp,
            desc.ctypes.data, ptrs,
            bits.ctypes.data, vals.ctypes.data, 2, 2, 0, *band)

    assert progressive(1, (0, 0, 0, 1)) == -4  # DC first: the empty DC table
    assert progressive(1, (0, 0, 1, 0)) == 0  # DC refinement reads bits only
    coef[:] = 0
    for ncomp, band in [(1, (0, 5, 0, 0)), (2, (1, 5, 0, 0)), (1, (6, 5, 0, 0)),
                        (1, (1, 64, 0, 0)), (1, (1, 5, 2, 0)), (1, (1, 5, 0, 14)),
                        (1, (1, 5, -1, 0)), (5, (0, 0, 0, 0))]:
        assert progressive(ncomp, band) == -5, (ncomp, band)
    assert not coef.any()


def test_readers_take_jpegs(tmp_path):
    """load_image_rgb on a JPEG is JAX's (cv2's); the folder dataset reads
    JPEG frames as JAX's does; serve's input glob picks them up."""
    from hi3d_tpu.data.video_dataset import VideoTrainDataset as JaxVideoTrainDataset
    from hi3d_tpu.utils.image import load_image_rgb as jax_load_image_rgb
    from hi3d_tpu_torch.data.video_dataset import VideoTrainDataset
    from hi3d_tpu_torch.pipelines.serve import load_images
    from hi3d_tpu_torch.utils.image import load_image_rgb, read_image

    path = os.path.join(FIXTURE_DIR, "demo3_q30_rst1_389x517.jpg")
    np.testing.assert_array_equal(load_image_rgb(path), jax_load_image_rgb(path))
    gray = os.path.join(FIXTURE_DIR, "gray_q75_29x37.jpg")
    np.testing.assert_array_equal(load_image_rgb(gray), jax_load_image_rgb(gray))
    assert read_image(gray).shape == (29, 37, 1)
    for name in FIXTURES:  # progressive, 4:1:1, 4:4:0, CMYK, RGB-coded among them
        path = os.path.join(FIXTURE_DIR, name)
        np.testing.assert_array_equal(load_image_rgb(path), jax_load_image_rgb(path))

    folder = tmp_path / "renders" / "obj"
    folder.mkdir(parents=True)
    for i in range(96):
        img = _demo(16, 16, seed=i)
        (folder / f"{i:03d}.jpg").write_bytes(encode(img, 60 + i % 40, "420"))
    kw = dict(width=16, height=16, sample_frames=16)
    got = VideoTrainDataset(str(tmp_path / "renders"), **kw).sample(np.random.RandomState(2))
    want = JaxVideoTrainDataset(str(tmp_path / "renders"), **kw).sample(np.random.RandomState(2))
    np.testing.assert_array_equal(got["video"].transpose(0, 2, 3, 1), want["video"])

    images = load_images([str(folder / "000.jpg")], (16, 16))
    rgb = load_image_rgb(str(folder / "000.jpg")).astype(np.float32)
    np.testing.assert_array_equal(images[0], (rgb / 255.0 - 0.5) * 2.0)


def test_new_modules_run_without_jax_cv2_or_pil():
    """The modules this slice adds (and the readers they touch) import and
    run in a process where jax, hi3d_tpu, cv2 and PIL cannot import: every
    PNG, JPEG and WebP fixture decodes to its cv2 golden, and
    load_image_rgb reads each without cv2."""
    code = f"""
import sys
for name in ("jax", "hi3d_tpu", "cv2", "PIL"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
import hashlib, json, os
import numpy as np, torch, tempfile
from hi3d_tpu_torch.utils.jpeg import read_jpeg
from hi3d_tpu_torch.utils.image import load_image_rgb, read_image
from hi3d_tpu_torch.utils.webp import read_webp
for kind in ("torch_jpeg", "torch_png", "torch_webp"):
    folder = os.path.join({ROOT!r}, "tests", "data", kind)
    with open(os.path.join(folder, "goldens.json")) as f:
        goldens = json.load(f)
    for name, want in goldens.items():
        img = read_image(os.path.join(folder, name))
        got = {{"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}}
        assert got == want, name
        assert load_image_rgb(os.path.join(folder, name)).shape == img.shape[:2] + (3,), name
from hi3d_tpu_torch.utils.logger import setup_logger
from hi3d_tpu_torch.ops.softsplat import softsplat
from hi3d_tpu_torch.ops.correlation import correlation
from hi3d_tpu_torch.data import transforms as T
from hi3d_tpu_torch.training.step import TrainStep
img = read_jpeg({os.path.join(FIXTURE_DIR, 'c422_q50_rst2_31x45.jpg')!r})
assert img.shape == (31, 45, 3)
assert load_image_rgb({os.path.join(FIXTURE_DIR, 'gray_q75_29x37.jpg')!r}).shape == (29, 37, 3)
assert T.resize(img, 20, "bicubic").shape[0] == 20
assert T.affine(img, 10, (1, 2), 1.1, 3).shape == img.shape
assert T.adjust_hue(img, 0.2).shape == img.shape
x = torch.rand(1, 3, 8, 8)
assert softsplat(x, torch.rand(1, 2, 8, 8), torch.rand(1, 1, 8, 8), "soft").shape == x.shape
assert correlation(x, x).shape == (1, 81, 8, 8)
setup_logger("hi3d_tpu_torch.test", tempfile.mkdtemp()).info("ok")
print("ok")
"""
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().endswith("ok")


def test_logger_matches_jax(tmp_path, capsys):
    """setup_logger: cached, console on rank 0 only, log.txt on every rank
    (`.rank{r}` past 0), the JAX logger's format; the rank from the
    process group when not given (0 outside one)."""
    import logging

    from hi3d_tpu.utils.logger import setup_logger as jax_setup_logger
    from hi3d_tpu_torch.utils.logger import setup_logger

    out = str(tmp_path / "logs")
    log = setup_logger("port_logger", out)
    assert setup_logger("port_logger", out) is log
    log.info("hello")
    assert "port_logger INFO] hello" in capsys.readouterr().out
    rank1 = setup_logger("port_logger_r1", out, distributed_rank=1)
    rank1.info("from rank 1")
    assert capsys.readouterr().out == ""
    for h in log.handlers + rank1.handlers:
        h.flush()
    with open(os.path.join(out, "log.txt")) as f:
        assert f.read().rstrip().endswith("port_logger INFO] hello")
    with open(os.path.join(out, "log.txt.rank1")) as f:
        assert "from rank 1" in f.read()
    jout = str(tmp_path / "jax")
    jlog = jax_setup_logger("jax_logger", jout, distributed_rank=0)
    assert [type(h) for h in jlog.handlers] == [type(h) for h in log.handlers]
    assert [h.formatter._fmt for h in jlog.handlers] == [h.formatter._fmt for h in log.handlers]
    assert log.level == jlog.level == logging.DEBUG and not log.propagate
    txt = setup_logger("port_logger_txt", str(tmp_path / "one.txt"))
    assert txt.handlers[-1].baseFilename == str(tmp_path / "one.txt")


if __name__ == "__main__":
    write_fixtures()
