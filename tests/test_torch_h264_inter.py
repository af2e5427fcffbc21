"""The port's inter-coded H.264 (utils/h264.py, csrc/h264_{encode,decode}.c,
csrc/h264_common.h) on the CPU: IDR then P pictures with quarter-sample
motion compensation and the deblocking filter, held three ways on every
frame, bit for bit:

- the port's decode equals the encoder's reconstruction;
- ffmpeg's (libavcodec through cv2) luma equals the port's;
- ffmpeg's RGB (libswscale's yuv420p → BGR24, which h264.to_rgb ports)
  equals the port's; cv2 reads as many frames at the same rate.

The cases cover clips with motion (pans of demo/3.png by quarter samples, a
rotation, a pan across the picture's border, still frames, noise) at 16²,
64×48, 66×50 (cropped) and 512², QP 0 to 51, the filter's three
disable_deblocking_filter_idc values and its offsets (at QP ≥ 26: at QP 5
its α is 0), slices, 1-4 references, every forced partition and
sub-partition, intra and I_PCM macroblocks in P pictures, skip runs across
row and slice ends, and 40 pictures (frame_num wraps) with POC types 0 and
2. Each asserts through the codec's statistics (h264.STATS, counted by the
encoder and the decoder alike, which must agree) that its path ran. Then:
the P stream is smaller than the intra-only one, the stream does not depend
on the host's thread count, and what the decoder refuses (reference list
modification, a frame_num gap, constrained intra prediction in P slices)
names what it found, and reads through cv2 where it is a valid stream.
"""

import os
import sys

import cv2
import numpy as np
import pytest

import torch_threads  # noqa: F401
from hi3d_tpu_torch.utils import h264, mp4
from hi3d_tpu_torch.utils.image import load_image_rgb
from hi3d_tpu_torch.utils.video import import_video

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPS = 8


def _demo():
    return load_image_rgb(os.path.join(ROOT, "demo", "3.png"))[..., :3].astype(np.float64)


def _sample(img, ys, xs):
    """Bilinear samples of img at (ys, xs), clamped to it, rounded."""
    h, w = img.shape[:2]
    ys, xs = np.clip(ys, 0, h - 1.001), np.clip(xs, 0, w - 1.001)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    a = img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx
    b = img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx
    return np.ascontiguousarray((a * (1 - fy) + b * fy).round().clip(0, 255).astype(np.uint8))


def _pan(n, h, w, dx, dy, x0, y0):
    """demo/3.png's window at (x0, y0) moved (dx, dy) samples a frame"""
    img = _demo()
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    return [_sample(img, yy + y0 + t * dy, xx + x0 + t * dx) for t in range(n)]


def _rotation(n, h, w, deg=2.0, cy=256, cx=256):
    img = _demo()
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yy, xx = yy - h / 2, xx - w / 2
    out = []
    for t in range(n):
        a = np.deg2rad(deg * t)
        out.append(_sample(img, cy + np.cos(a) * yy - np.sin(a) * xx,
                           cx + np.sin(a) * yy + np.cos(a) * xx))
    return out


def _texture(n, h, w, dx=0.75, dy=0.5):
    """a seeded sinusoid texture moving by (dx, dy) samples a frame"""
    phase = np.random.RandomState(h * w).uniform(0, 6.28, 3)
    out = []
    for t in range(n):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        yy, xx = yy + t * dy, xx + t * dx
        out.append(np.stack([128 + 100 * np.sin(xx / 7.0 + phase[0]) * np.cos(yy / 5.0),
                             128 + 90 * np.cos(xx / 5.0 + yy / 11.0 + phase[1]),
                             128 + 60 * np.sin((xx + yy) / 9.0 + phase[2])], -1)
                   .round().clip(0, 255).astype(np.uint8))
    return out


def _noise(n, h, w, seed=0):
    rnd = np.random.RandomState(seed)
    return [rnd.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(n)]


def _still(n, h, w):
    return [_texture(1, h, w)[0]] * n


def _cv2_read(path, convert_rgb=True):
    cap = cv2.VideoCapture(str(path))
    if not convert_rgb:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames, fps


def _held(tmp_path, frames, qp, **options):
    """Encodes, writes, decodes and reads back with cv2; asserts the three
    bit-equalities and the frame count and rate; returns the encoder's and
    the decoder's statistics (equal) and the encoding."""
    h, w = frames[0].shape[:2]
    enc_stats, dec_stats = {}, {}
    enc = h264.encode(frames, qp, FPS, stats=enc_stats, **options)
    path = str(tmp_path / "inter.mp4")
    mp4.write_mp4(path, enc.sps, enc.pps, enc.samples, w, h, FPS, enc.sync)
    track = mp4.read_mp4(path)
    planes = h264.decode(track.sps, track.pps, track.samples, track.length_size, stats=dec_stats)
    assert len(planes) == len(frames) and track.sync == enc.sync
    for got, want in zip(planes, enc.recon):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    luma, fps = _cv2_read(path, convert_rgb=False)
    rgb, _ = _cv2_read(path)
    assert len(luma) == len(rgb) == len(frames) and fps == FPS
    for y, r, p in zip(luma, rgb, planes):
        np.testing.assert_array_equal(np.asarray(y).reshape(-1)[:h * w].reshape(h, w), p[0])
        np.testing.assert_array_equal(r[..., ::-1], h264.to_rgb(*p))
    assert enc_stats == dec_stats
    return enc_stats, enc


def _pos(stats, keys):
    return {k: stats.get(k, 0) for k in keys if not stats.get(k, 0)}


QPELS = [f"qpel_{x}{y}" for y in range(4) for x in range(4)]

# name: (clip, QP, encode options, statistics that must be > 0, that must be 0)
CASES = {
    "pan_16": (lambda: _pan(4, 16, 16, 0.75, 0.25, 360, 300), 26, {},
               ["P", "skip", "skip_run_end"], []),
    "pan_64x48_qp0": (lambda: _pan(5, 48, 64, 0.25, 0.75, 330, 290), 0, {},
                      ["p16x16", "chroma_frac", "qpel_01"], ["bs1", "bs2", "bs3", "bs4"]),
    "pan_66x50_qp5": (lambda: _pan(5, 50, 66, 0.75, 0.25, 330, 290), 5, {},
                      ["p16x16", "intra_in_p", "qpel_30"], ["bs1", "bs2", "bs3", "bs4"]),
    "pan_512": (lambda: _pan(3, 512, 512, 1.25, 0.25, 0, 0), 26, {},
                ["skip", "p16x16", "bs1", "bs2", "bs3", "bs4", "slice_edge_filtered"], []),
    "rotation_512": (lambda: _rotation(4, 512, 512), 26, {}, QPELS + ["sub8x8", "i16x16"], []),
    "rotation_64x48_qp51": (lambda: _rotation(5, 48, 64, 3.0, 320, 360), 51, {},
                            ["skip", "bs3"], []),
    "border_pan_66x50": (lambda: _pan(5, 50, 66, 3.5, -2.25, 140, 330), 26, {},
                         ["mv_outside", "bs1"], []),
    "still_64x48": (lambda: _still(4, 48, 64), 26, dict(slice_rows=2),
                    ["skip", "skip_run_end", "skip_run_wrap"], ["p16x16"]),
    "noise_66x50_qp0": (lambda: _noise(3, 50, 66), 0, {}, ["pcm", "intra_in_p"], []),
    "noise_64x48_qp51": (lambda: _noise(3, 48, 64, 1), 51, {}, ["P"], []),
    "filter_idc0_offsets": (lambda: _texture(4, 48, 64), 30,
                            dict(filter_offsets=(3, -2), slice_rows=1),
                            ["bs1", "bs2", "bs3", "bs4", "slice_edge_filtered"], []),
    "filter_idc0_negative": (lambda: _texture(4, 48, 64), 40, dict(filter_offsets=(-4, 5)),
                             ["bs2", "bs4"], []),
    "filter_idc1": (lambda: _texture(4, 48, 64), 36, dict(filter_idc=1),
                    ["p16x16"], ["bs1", "bs2", "bs3", "bs4"]),
    "filter_idc2_slices": (lambda: _texture(4, 50, 66), 36, dict(filter_idc=2, slice_rows=1),
                           ["bs3", "bs4"], ["slice_edge_filtered"]),
    "refs_2": (lambda: _texture(5, 48, 64), 30, dict(refs=2), ["ref_idx_bit"], ["ref_idx_ue"]),
    "refs_3": (lambda: _texture(5, 48, 64), 30, dict(refs=3),
               ["ref_idx_ue", "ref_idx_nonzero"], []),
    "refs_4_8x8": (lambda: _texture(6, 48, 64), 30, dict(refs=4, partition="8x8"),
                   ["ref_idx_ue", "ref_idx_nonzero", "bs1"], []),
    "intra_in_p": (lambda: _texture(3, 48, 64), 26, dict(partition="intra"), ["intra_in_p", "i4x4"],
                   ["p16x16"]),
    "pcm_in_p": (lambda: _texture(3, 48, 64), 26, dict(partition="pcm"), ["pcm", "intra_in_p"], []),
    "frame_num_wrap_poc2": (lambda: _texture(40, 32, 48, 0.5, 0.25), 30, dict(slice_rows=1),
                            ["P"], []),
    "frame_num_wrap_poc0": (lambda: _texture(40, 32, 48, 0.25, 0.5), 30, dict(poc_type=0),
                            ["P"], []),
    "non_idr_i": (lambda: _texture(3, 48, 64), 26, dict(pictures="i"), ["I", "bs3"], ["P"]),
}
PARTITION_STATS = {"16x16": ["p16x16"], "16x8": ["p16x8"], "8x16": ["p8x16"],
                   "8x8": ["p8x8", "sub8x8"], "8x8ref0": ["p8x8ref0", "sub8x8"],
                   "8x4": ["sub8x4"], "4x8": ["sub4x8"], "4x4": ["sub4x4"],
                   "mixed": ["sub8x8", "sub8x4", "sub4x8", "sub4x4"]}
for _p, _keys in PARTITION_STATS.items():
    CASES[f"partition_{_p}"] = (lambda: _texture(3, 48, 64), 30,
                                dict(partition=_p, refs=2 if _p == "8x8ref0" else 1), _keys, [])


@pytest.mark.parametrize("case", list(CASES))
def test_stream_is_its_reconstruction_and_ffmpegs(tmp_path, case):
    make, qp, options, nonzero, zero = CASES[case]
    frames = make()
    stats, _ = _held(tmp_path, frames, qp, **options)
    assert not _pos(stats, nonzero), f"paths that did not run: {_pos(stats, nonzero)}"
    assert all(not stats.get(k, 0) for k in zero), {k: stats.get(k) for k in zero}
    if "wrap" in case:
        assert stats["P"] == len(frames) - 1 > 16
    if case.startswith("partition_"):  # every macroblock of a P picture, or I_PCM where cheaper
        part = case[len("partition_"):]
        mb_type = {"16x16": "p16x16", "16x8": "p16x8", "8x16": "p8x16"}.get(part, "p8x8")
        inter = sum(stats[k] for k in ("p16x16", "p16x8", "p8x16", "p8x8", "p8x8ref0"))
        assert inter + stats["intra_in_p"] == stats["P"] * 12
        if part == "8x8ref0":  # P_8x8 where the first P picture has one reference
            assert stats["p8x8ref0"] == inter - 12 and stats["p8x8"] == 12
        else:
            assert stats[mb_type] == inter
        if part in ("8x4", "4x8", "4x4"):
            assert stats[nonzero[0]] == 4 * inter
        if part == "mixed":
            assert all(stats[k] == inter for k in nonzero)


def _demo_pan_512(n=16):
    """demo/3.png panned by 1.25 samples across and 0.25 down a frame"""
    img = _demo()
    big = np.pad(img, ((0, 8), (0, 24), (0, 0)), mode="reflect")
    yy, xx = np.mgrid[0:512, 0:512].astype(np.float64)
    return [_sample(big, yy + 0.25 * t, xx + 1.25 * t) for t in range(n)]


@pytest.mark.parametrize("qp", [5, 26])
def test_p_stream_is_smaller_than_intra_only(qp):
    frames = _demo_pan_512()
    p = h264.encode(frames, qp, FPS)
    intra = h264.encode(frames, qp, FPS, pictures="idr")
    p_bytes, i_bytes = sum(map(len, p.samples)), sum(map(len, intra.samples))
    print(f"[sizes] demo/3.png pan, 16 frames of 512x512 at QP {qp}: P stream {p_bytes} bytes, "
          f"intra-only {i_bytes} bytes")
    assert p_bytes < i_bytes


def test_first_mp4_frames_at_quality_9():
    """The 16 frames of the JAX package's cv2-written first.mp4 (70,870
    bytes) through both streams at quality 9 (QP 5)."""
    path = os.path.join(ROOT, "tests", "data", "torch_mp4v", "first.mp4")
    frames = list(import_video(path))
    qp = h264.quality_to_qp(9)
    p = h264.encode(frames, qp, FPS)
    intra = h264.encode(frames, qp, FPS, pictures="idr")
    p_bytes, i_bytes = sum(map(len, p.samples)), sum(map(len, intra.samples))
    print(f"[sizes] {path}: {len(frames)} frames, {os.path.getsize(path)} bytes as JAX wrote them; "
          f"P stream {p_bytes} bytes, intra-only {i_bytes} bytes at QP {qp}")
    assert len(frames) == 16 and p_bytes < i_bytes


def test_stream_does_not_depend_on_threads():
    frames = _texture(4, 96, 80)
    one = h264.encode(frames, 26, FPS, slice_rows=1, threads=1)
    eight = h264.encode(frames, 26, FPS, slice_rows=1, threads=8)
    assert one.samples == eight.samples
    assert len(h264.split_sample(one.samples[1], 4, "sample 1")) == 6  # a slice a row


def test_slices_cost_bytes_against_one_slice():
    """Slices of 4 rows (the default: 8 at 512²) against one slice a picture
    on the demo pan at QP 26; both decode as ffmpeg decodes them (held in
    the cases above), the cut costs a bounded share."""
    frames = _demo_pan_512(4)
    cut = sum(map(len, h264.encode(frames, 26, FPS).samples))
    whole = sum(map(len, h264.encode(frames, 26, FPS, slice_rows=0).samples))
    print(f"[sizes] demo pan, 4 frames of 512x512 at QP 26: 8 slices a picture {cut} bytes, "
          f"one slice {whole} bytes")
    assert whole < cut < 1.5 * whole


def _with_list_modification(sample):
    """The P slices of `sample` with ref_pic_list_modification_flag_l0 1 and
    an empty modification list (modification_of_pic_nums_idc 3): the same
    pictures, a syntax the decoder refuses."""
    out = []
    for nal in h264.split_sample(sample, 4, "sample"):
        r = h264._BitReader(h264.unescape(nal[1:]), "slice")
        r.ue(), r.ue(), r.ue(), r.u(4)
        assert r.u(1) == 0  # num_ref_idx_active_override_flag
        bits = "".join(format(b, "08b") for b in h264.unescape(nal[1:]))
        stop = bits.rindex("1")
        bits = bits[:r.pos] + "1" + "00100" + bits[r.pos + 1:stop]  # flag 1, ue(3)
        w = h264._BitWriter()
        w.bits.append(bits)
        body = nal[:1] + h264.escape(w.rbsp())
        out.append(len(body).to_bytes(4, "big") + body)
    return b"".join(out)


REFUSED = {
    "list_modification": (lambda e: e.samples[:1] + [_with_list_modification(s)
                                                      for s in e.samples[1:]],
                          "reference picture list modification"),
    "frame_num_gap": (lambda e: e.samples[:2] + e.samples[3:], "gap in frame_num"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_streams_name_what_they_hold_and_read_through_cv2(tmp_path, monkeypatch, case):
    make, words = REFUSED[case]
    frames = _texture(5, 48, 64)
    enc = h264.encode(frames, 26, FPS)
    samples = make(enc)
    path = str(tmp_path / f"{case}.mp4")
    mp4.write_mp4(path, enc.sps, enc.pps, samples, 64, 48, FPS)
    with pytest.raises(h264.Unsupported, match=words):
        h264.decode([enc.sps], [enc.pps], samples)
    theirs, _ = _cv2_read(path)
    got = import_video(path)  # cv2 reads what the port refuses
    np.testing.assert_array_equal(got, np.stack(theirs)[..., ::-1])
    if case == "list_modification":  # the same pictures as the stream without it
        np.testing.assert_array_equal(got, np.stack([h264.to_rgb(*r) for r in enc.recon]))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(h264.Unsupported, match=words):
        import_video(path)


def test_constrained_intra_prediction_in_p_is_refused():
    enc = h264.encode(_texture(2, 32, 32), 26, FPS)
    pps = bytearray(h264.unescape(enc.pps))
    w = h264._BitWriter()
    for v in (0, 0):
        w.ue(v)
    w.u(2, 0)
    for v in (0, 0, 0):
        w.ue(v)
    w.u(3, 0)
    w.se(0)
    w.se(0)
    w.se(0)
    w.u(3, 0b110)  # deblocking_filter_control_present, constrained_intra_pred, no redundant_pic_cnt
    assert pps[0] == 0x68
    with pytest.raises(h264.Unsupported, match="constrained intra prediction"):
        h264.decode([enc.sps], [b"\x68" + h264.escape(w.rbsp())], enc.samples)
