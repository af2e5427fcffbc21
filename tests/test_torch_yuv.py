"""The port's yuv420p → RGB conversion (csrc/h264_decode.c
hi3d_h264_yuv_to_rgb, utils/h264.to_rgb), which both mp4 readers use,
against cv2's: libswscale's unscaled yuv420p → BGR24 path as cv2's FFMPEG
backend runs it, channels reversed.

- Every (Y, U, V) triple: one 4096×4096 frame holds all 2²⁴ of them (65,536
  (U, V) pairs × 64 chroma blocks × the 4 luma samples under each). cv2
  reads the frame from a raw .y4m file (its BGR of a y4m equals its BGR of
  an mp4 with the same planes), the port converts the same planes; the two
  are bit-equal, and the port's table of all triples has the SHA-256
  committed in tests/data/torch_yuv/goldens.json (cv2 5.0.0, swscale
  9.5.101), a test that imports no cv2.
- Seeded planes at widths 2, 6, 98, 100 and 1024: bit-equal to cv2, so the
  conversion does not depend on position or width.
- Odd sizes are refused, as before.
"""

import hashlib
import json
import os

import numpy as np
import pytest

import torch_threads  # noqa: F401
from hi3d_tpu_torch.utils import h264

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_yuv", "goldens.json")
SIDE = 4096


def probe_planes():
    """Y, U, V of a 4096² frame that holds every (Y, U, V) once: chroma
    sample (r, c) carries the pair (r % 32) · 2048 + c (U its high byte, V
    its low), block r // 32 of the 64, and the 4 luma samples under it
    4 · (r // 32) + 0..3."""
    r, c = np.mgrid[0:SIDE // 2, 0:SIDE // 2]
    pair = (r % 32) * (SIDE // 2) + c
    u, v = (pair >> 8).astype(np.uint8), (pair & 255).astype(np.uint8)
    y = np.empty((SIDE, SIDE), np.uint8)
    for dy in range(2):
        for dx in range(2):
            y[dy::2, dx::2] = 4 * (r // 32) + 2 * dy + dx
    return y, u, v


def table(rgb, y, u, v):
    """The [Y][U][V] → RGB table of a conversion of the probe planes."""
    out = np.zeros((256, 256, 256, 3), np.uint8)
    full = [np.repeat(np.repeat(p, 2, 0), 2, 1) for p in (u, v)]
    out[y, full[0], full[1]] = rgb
    return out


def cv2_rgb(tmp_path, y, u, v):
    """cv2's RGB of one frame of planes, read from a .y4m file."""
    import cv2

    path = str(tmp_path / "frame.y4m")
    h, w = y.shape
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W%d H%d F25:1 Ip A1:1 C420jpeg\nFRAME\n" % (w, h))
        for p in (y, u, v):
            f.write(np.ascontiguousarray(p).tobytes())
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    ok, bgr = cap.read()
    cap.release()
    assert ok and bgr.shape == (h, w, 3)
    return bgr[..., ::-1]


def test_every_triple_equals_cv2(tmp_path):
    y, u, v = probe_planes()
    np.testing.assert_array_equal(h264.to_rgb(y, u, v), cv2_rgb(tmp_path, y, u, v))


def test_every_triple_equals_the_committed_table():
    """No cv2 here: the port's table against the digest of cv2's."""
    y, u, v = probe_planes()
    with open(GOLDENS) as f:
        want = json.load(f)["table_sha256"]
    got = table(h264.to_rgb(y, u, v), y, u, v)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want


@pytest.mark.parametrize("width", [2, 6, 98, 100, 1024])
def test_widths_equal_cv2(tmp_path, width):
    rnd = np.random.RandomState(width)
    h = 34
    y = rnd.randint(0, 256, (h, width)).astype(np.uint8)
    u, v = (rnd.randint(0, 256, (h // 2, width // 2)).astype(np.uint8) for _ in range(2))
    np.testing.assert_array_equal(h264.to_rgb(y, u, v), cv2_rgb(tmp_path, y, u, v))


def test_odd_sizes_are_refused():
    y = np.zeros((4, 5), np.uint8)
    with pytest.raises(ValueError, match="not 4:2:0 of even size"):
        h264.to_rgb(y, np.zeros((2, 2), np.uint8), np.zeros((2, 2), np.uint8))
