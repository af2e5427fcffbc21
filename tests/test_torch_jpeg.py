"""The port's JPEG decoder (hi3d_tpu_torch/utils/jpeg.py) against cv2's
`imdecode(..., IMREAD_UNCHANGED)` (OpenCV's libjpeg-turbo), bit for bit, on
JPEGs that cv2 encodes: qualities 10–100, 4:4:4, 4:2:2 and 4:2:0 chroma,
grey, restart intervals, sizes from 1×1 to 517×389; the formats it refuses;
the readers that take JPEGs now (load_image_rgb, the folder and tar
datasets, serve's input glob); and the new modules with jax, cv2 and PIL
blocked.

tests/data/torch_jpeg/ holds the committed fixtures (the chip smoke decodes
them on a machine without cv2) and goldens.json, the shape and SHA-256 of
cv2's decode of each. `python tests/test_torch_jpeg.py` writes them again
from demo/3.png with `FIXTURES`' settings.
"""

import hashlib
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
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
# name: (height, width, quality, sampling or "gray", restart interval)
FIXTURES = {
    "demo3_q90.jpg": (512, 512, 90, "420", 0),
    "demo3_q30_rst1_389x517.jpg": (389, 517, 30, "420", 1),
    "c444_q95_17x33.jpg": (17, 33, 95, "444", 0),
    "c422_q50_rst2_31x45.jpg": (31, 45, 50, "422", 2),
    "c420_q10_3x5.jpg": (3, 5, 10, "420", 0),
    "c420_q100_1x1.jpg": (1, 1, 100, "420", 0),
    "gray_q75_29x37.jpg": (29, 37, 75, "gray", 0),
}


def _demo(h, w, seed=0):
    """demo/3.png at (h, w) with a little seeded noise (so that the high
    frequencies carry data)."""
    img = cv2.imread(os.path.join(ROOT, "demo", "3.png"), cv2.IMREAD_COLOR)
    if (h, w) != img.shape[:2]:
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    noise = np.random.RandomState(seed).randint(-12, 13, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def encode(img, quality, sampling, restart=0):
    """cv2's JPEG of a BGR (or grey) image."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if sampling != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def make_fixture(name):
    h, w, q, sampling, rst = FIXTURES[name]
    img = _demo(h, w)
    return encode(img[..., 1] if sampling == "gray" else img, q, sampling, rst)


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


@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
@pytest.mark.parametrize("restart", [0, 3])
def test_decode_matches_cv2(sampling, restart):
    """Bit-equal to cv2 across qualities 10–100 and sizes 1×1 to 517×389."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg

    sizes = [(1, 1), (2, 3), (5, 4), (7, 9), (8, 8), (16, 16), (17, 33), (31, 30), (389, 517)]
    for i, (h, w) in enumerate(sizes):
        for q in ((10, 30, 50, 75, 90, 100) if h < 100 else (10, 85)):
            img = _demo(h, w, seed=i)
            blob = encode(img[..., 0] if sampling == "gray" else img, q, sampling, restart)
            got = decode_jpeg(blob)
            want = cv2_rgb(blob)
            assert got.dtype == np.uint8 and got.shape == want.shape, (h, w, q)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} q{q}")


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


def _patched(blob, marker, offset, value):
    i = blob.index(marker)
    return blob[:i + offset] + bytes([value]) + blob[i + offset + 1:]


def test_unsupported_jpegs_raise():
    """Progressive, arithmetic-coded (SOF9), 12-bit and CMYK files raise a
    ValueError that names the format; so do bytes that are no JPEG."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg

    img = _demo(24, 40)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive JPEG"):
        decode_jpeg(prog.tobytes())
    base = encode(img, 80, "420")
    with pytest.raises(ValueError, match="arithmetic-coded JPEG"):
        decode_jpeg(_patched(base, b"\xff\xc0", 1, 0xC9))
    with pytest.raises(ValueError, match="12-bit JPEG"):
        decode_jpeg(_patched(base, b"\xff\xc0", 4, 12))
    sof = (b"\xff\xc0\x00\x14\x08\x00\x10\x00\x10\x04" + b"\x01\x11\x00\x02\x11\x00"
           + b"\x03\x11\x00\x04\x11\x00")
    with pytest.raises(ValueError, match="CMYK"):
        decode_jpeg(b"\xff\xd8" + sof + b"\xff\xd9")
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="x.jpg: .*without a frame"):
        decode_jpeg(b"\xff\xd8\xff\xd9", "x.jpg")


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


@pytest.mark.parametrize("marker,offset,value,match", MALFORMED)
def test_malformed_headers_raise(marker, offset, value, match):
    """A header byte out of range (a scan's component count or table ids, a
    Huffman table's class, id or size, sampling factors, repeated component
    ids, segment lengths) raises a ValueError naming the file before any of
    it reaches the C decoder."""
    from hi3d_tpu_torch.utils.jpeg import decode_jpeg

    blob = _fixture("c422_q50_rst2_31x45.jpg")
    with pytest.raises(ValueError, match=f"bad.jpg: .*{match}"):
        decode_jpeg(_patched(blob, marker, offset, value), "bad.jpg")


def test_scan_decoder_checks_its_arguments():
    """The C entry point refuses a component count, table id, sampling or
    block grid outside its arrays (its second guard behind the header
    checks) and writes nothing."""
    import ctypes

    from hi3d_tpu_torch.utils.jpeg import _native

    lib = _native()
    coef = np.zeros((2, 2, 64), np.int16)
    ptrs = (ctypes.c_void_p * 5)(*[coef.ctypes.data] * 5)
    bits, vals = np.zeros((8, 17), np.uint8), np.zeros((8, 256), np.uint8)
    data = np.zeros(16, np.uint8)
    end = ctypes.c_long(0)

    def call(ncomp, row, mcus=(2, 2)):
        desc = np.array([row] * max(ncomp, 1), np.int32)
        return lib.hi3d_jpeg_decode_scan(data.ctypes.data, data.size, ctypes.byref(end), ncomp,
                                         desc.ctypes.data, ptrs, bits.ctypes.data,
                                         vals.ctypes.data, mcus[0], mcus[1], 0)

    good = [1, 1, 0, 0, 2, 2]
    assert call(1, good) == -4  # the arguments pass; the empty tables do not
    for ncomp, row, mcus in [(5, good, (2, 2)), (0, good, (2, 2)),
                             (1, [1, 1, 15, 0, 2, 2], (2, 2)), (1, [1, 1, 0, 15, 2, 2], (2, 2)),
                             (1, [0, 1, 0, 0, 2, 2], (2, 2)), (1, [1, 5, 0, 0, 2, 2], (2, 2)),
                             (1, good, (3, 2)), (1, good, (2, 3)), (1, good, (-1, 2))]:
        assert call(ncomp, row, mcus) == -5, (ncomp, row, mcus)
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
    run in a process where jax, hi3d_tpu, cv2 and PIL cannot import."""
    code = f"""
import sys
for name in ("jax", "hi3d_tpu", "cv2", "PIL"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
import numpy as np, torch, tempfile
from hi3d_tpu_torch.utils.jpeg import read_jpeg
from hi3d_tpu_torch.utils.image import load_image_rgb
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
