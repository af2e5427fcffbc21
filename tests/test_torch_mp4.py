"""The port's mp4 output and input (utils/h264.py, utils/mp4.py,
csrc/h264_{encode,decode}.c, utils/video.py) on the CPU, held against the
encoder's own reconstruction, against ffmpeg's decoder (through cv2) and
against the JAX package's readers.

- Round trip: the port's decode of its mp4 (IDR then P pictures, the loop
  filter on) equals the encoder's reconstruction bit for bit, over random
  and smooth content, at 16², 64×48, 66×50 (cropped) and 512², QP 0, 5, 26
  and 51, and over streams of several slices a picture, non-IDR I pictures
  and pic_order_cnt_type 0 (tests/test_torch_h264_inter.py holds the P
  pictures' every path).
- ffmpeg: cv2 reads the same frame count and fps; its luma
  (CAP_PROP_CONVERT_RGB off) and its RGB (libswscale's yuv420p → BGR24,
  which h264.to_rgb ports) are bit-equal to the port's reader's.
- JAX: `hi3d_tpu.utils.video.import_video` (cv2 here: imageio has no ffmpeg
  plugin) and the port's `import_video` agree bit for bit on a port mp4;
  JAX's and the port's `v2v.prepare_inputs` select the same frames of it.
- Refusals: CABAC, a B slice, weighted prediction, a long-term reference,
  adaptive reference marking (MMCO), High profile and interlace raise
  `h264.Unsupported` naming them when cv2 and imageio are hidden; cv2's
  `mp4v` reads without them (utils/mpeg4.py; tests/test_torch_mpeg4.py
  holds that decoder).
- Damage: truncated and bit-flipped files (of P streams with the filter
  on) raise a ValueError or decode, never crash.
"""

import struct
import sys

import cv2
import numpy as np
import pytest

import torch_threads  # noqa: F401
from hi3d_tpu.pipelines import v2v as jax_v2v
from hi3d_tpu.utils.video import import_video as jax_import_video
from hi3d_tpu_torch.pipelines.v2v import prepare_inputs
from hi3d_tpu_torch.utils import h264, mp4, mpeg4
from hi3d_tpu_torch.utils.png import write_png
from hi3d_tpu_torch.utils.video import export_to_video, import_video, read_mp4



def _smooth(h, w, t):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([128 + 100 * np.sin(xx / 13.0 + t) * np.cos(yy / 7.0),
                     128 + 90 * np.cos(xx / 5.0 + yy / 11.0),
                     xx * 255.0 / w], -1).clip(0, 255).astype(np.uint8)


def _clip(h, w, n=3, seed=0):
    rnd = np.random.RandomState(seed)
    return [rnd.randint(0, 256, (h, w, 3)).astype(np.uint8) if i % 2 else _smooth(h, w, i)
            for i in range(n)]


def _write(path, enc, w, h, fps=8):
    mp4.write_mp4(str(path), enc.sps, enc.pps, enc.samples, w, h, fps)
    return str(path)


def _port_planes(path):
    track = mp4.read_mp4(str(path))
    return h264.decode(track.sps, track.pps, track.samples, track.length_size)


def _cv2_read(path, convert_rgb=True):
    cap = cv2.VideoCapture(str(path))
    if not convert_rgb:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames, fps, count


@pytest.mark.parametrize("qp", [0, 5, 26, 51])
@pytest.mark.parametrize("size", [(16, 16), (48, 64), (50, 66), (512, 512)])
def test_decode_equals_reconstruction(tmp_path, size, qp):
    h, w = size
    enc = h264.encode(_clip(h, w, 2 if h == 512 else 3), qp, 8)
    planes = _port_planes(_write(tmp_path / "a.mp4", enc, w, h))
    assert len(planes) == len(enc.recon)
    for got, want in zip(planes, enc.recon):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(read_mp4(str(tmp_path / "a.mp4")),
                                  np.stack([h264.to_rgb(*r) for r in enc.recon]))


def test_pcm_pictures_are_the_colour_conversion():
    """Random pictures cost more than I_PCM at QP 0, so every macroblock is
    sent raw: the reconstruction is the encoder's colour conversion, which
    `rgb_to_yuv420` gives alone (chip_smoke's PSNR reference)."""
    frame = np.random.RandomState(5).randint(0, 256, (48, 64, 3)).astype(np.uint8)
    (recon,) = h264.encode([frame], 0, 8).recon
    for a, b in zip(recon, h264.rgb_to_yuv420(frame)):
        np.testing.assert_array_equal(a, b)
    r, g, b = frame.astype(int).transpose(2, 0, 1)
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    np.testing.assert_array_equal(recon[0], y)


@pytest.mark.parametrize("options", [dict(slice_rows=1), dict(pictures="i"),
                                     dict(slice_rows=2, pictures="i", poc_type=0)])
def test_stream_variants_against_ffmpeg(tmp_path, options):
    """Several slices a picture, non-IDR I pictures, POC type 0: the port's
    decode is the reconstruction and ffmpeg's luma."""
    h, w = 96, 80
    enc = h264.encode(_clip(h, w, 4, seed=2), 5, 8, **options)
    path = _write(tmp_path / "v.mp4", enc, w, h)
    planes = _port_planes(path)
    luma, _, count = _cv2_read(path, convert_rgb=False)
    assert len(luma) == count == len(enc.recon)
    for got, want, y in zip(planes, enc.recon, luma):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(y).reshape(-1)[:h * w].reshape(h, w), got[0])


@pytest.mark.parametrize("size,fps", [((48, 64), 8), ((50, 66), 8), ((128, 96), 30)])
def test_ffmpeg_reads_the_port_mp4(tmp_path, size, fps):
    h, w = size
    frames = _clip(h, w, 5, seed=3) + [np.full((h, w, 3), c, np.uint8)
                                       for c in ([0, 0, 0], [255, 255, 255], [255, 0, 0])]
    enc = h264.encode(frames, 5, fps)
    path = _write(tmp_path / "f.mp4", enc, w, h, fps)
    port = import_video(path)
    luma, cv_fps, count = _cv2_read(path, convert_rgb=False)
    rgb, _, _ = _cv2_read(path)
    assert port.shape == (len(frames), h, w, 3)
    assert count == len(luma) == len(rgb) == len(frames) and cv_fps == fps
    assert mp4.read_mp4(path).fps == fps
    for y, r in zip(luma, enc.recon):
        np.testing.assert_array_equal(np.asarray(y).reshape(-1)[:h * w].reshape(h, w), r[0])
    np.testing.assert_array_equal(port, np.stack(rgb)[..., ::-1])


def test_jax_import_video_and_prepare_inputs_agree(tmp_path, monkeypatch):
    """A 31-frame stage-1 clip exported by the port (padded to 32 at fps 8):
    JAX's import_video (through cv2: imageio without its ffmpeg plugin
    hands the file to a plugin that reads no frames, so it is hidden) and
    the port's read it bit for bit, and both prepare_inputs pick the same
    last 20 frames (the padded tail included) with equal masks."""
    t, fps, clip, res = 31, 8, 20, 32
    colours = np.random.RandomState(3).permutation(256)[:t]
    frames = [np.full((res, res, 3), (c, 255 - c, (7 * c) % 256), np.uint8) for c in colours]
    for f, c in zip(frames, colours):
        f[4:12, 4:12] = (255 - c, c, 40)
    path = export_to_video(frames, str(tmp_path / "first_step" / "first.mp4"), fps=fps)
    assert path.endswith("first.mp4")
    clean = str(tmp_path / "clean.png")
    write_png(clean, np.full((res, res, 3), (20, 200, 90), np.uint8))

    monkeypatch.setitem(sys.modules, "imageio", None)
    ours, theirs = import_video(path), np.stack(jax_import_video(path))
    assert ours.shape == theirs.shape == (32, res, res, 3)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(import_video(path, max_frames=5), ours[:5])

    want, want_masks = jax_v2v.prepare_inputs(clean, path, clip, (res, res))
    got, got_masks = prepare_inputs(clean, path, clip, (res, res))
    assert got.shape == want.shape == (clip, res, res, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_masks, want_masks)
    padded = frames + [frames[-1]]
    for i in range(1, clip):  # each selected frame is nearest to the one JAX selects
        dist = [np.abs(got[i].astype(int) - f.astype(int)).mean() for f in padded]
        assert dist[32 - clip + i] == min(dist)


def _sps_bits(profile=66, frame_mbs_only=1):
    w = h264._BitWriter()
    w.u(8, profile)
    w.u(8, 0)
    w.u(8, 30)
    w.ue(0)
    if profile == 100:  # High: chroma_format_idc and the rest follow
        w.ue(1)
    w.ue(0)
    w.ue(2)
    w.ue(1)
    w.u(1, 0)
    w.ue(3)
    w.ue(2)
    w.u(1, frame_mbs_only)
    return b"\x67" + h264.escape(w.rbsp())


def _pps_cabac():
    w = h264._BitWriter()
    w.ue(0)
    w.ue(0)
    w.u(1, 1)  # entropy_coding_mode_flag
    w.u(1, 0)
    return b"\x68" + h264.escape(w.rbsp())


def _pps_weighted(qp=26):
    w = h264._BitWriter()
    for v in (0, 0):
        w.ue(v)
    w.u(1, 0)
    w.u(1, 0)
    for v in (0, 0, 0):
        w.ue(v)
    w.u(1, 1)  # weighted_pred_flag
    w.u(2, 0)
    w.se(qp - 26)
    w.se(0)
    w.se(0)
    w.u(1, 1)
    w.u(1, 0)
    w.u(1, 0)
    return b"\x68" + h264.escape(w.rbsp())


def _slice(slice_type=7, deblocking=1, idr=True, marking=(0, 0)):
    """An I slice header (IDR: idr_pic_id 0; else frame_num 1) with the
    dec_ref_pic_marking bits `marking` (IDR: no_output_of_prior_pics,
    long_term_reference; else adaptive_ref_pic_marking_mode alone)."""
    w = h264._BitWriter()
    w.ue(0)
    w.ue(slice_type)
    w.ue(0)
    w.u(4, 0 if idr else 1)
    if idr:
        w.ue(0)  # idr_pic_id
        w.u(1, marking[0])
    w.u(1, marking[1])
    w.se(0)
    w.ue(deblocking)
    if deblocking != 1:
        w.se(0)
        w.se(0)
    nal = (b"\x65" if idr else b"\x61") + h264.escape(w.rbsp())
    return struct.pack(">I", len(nal)) + nal


@pytest.fixture
def good():
    return h264.encode(_clip(64, 48, 2), 26, 8)


REFUSALS = {
    "cabac": (lambda e: (e.sps, _pps_cabac(), e.samples), "CABAC"),
    "b_slice": (lambda e: (e.sps, e.pps, [_slice(slice_type=6)]), "a B slice"),
    "weighted_pred": (lambda e: (e.sps, _pps_weighted(), e.samples), "weighted prediction"),
    "long_term": (lambda e: (e.sps, e.pps, [_slice(marking=(0, 1))]), "long-term reference"),
    "mmco": (lambda e: (e.sps, e.pps, [e.samples[0], _slice(idr=False, marking=(0, 1))]),
             "adaptive reference picture marking"),
    "high_profile": (lambda e: (_sps_bits(100), e.pps, e.samples), "High profile"),
    "interlace": (lambda e: (_sps_bits(frame_mbs_only=0), e.pps, e.samples), "interlace"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_streams_outside_the_subset_are_refused(tmp_path, monkeypatch, good, case):
    make, words = REFUSALS[case]
    sps, pps, samples = make(good)
    path = str(tmp_path / f"{case}.mp4")
    mp4.write_mp4(path, sps, pps, samples, 48, 64, 8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(h264.Unsupported, match=words):
        import_video(path)


def test_cv2_mp4v_is_refused_without_cv2_and_read_with_it(tmp_path, monkeypatch):
    """cv2's `mp4v` (MPEG-4 Part 2), which the port refused until
    utils/mpeg4.py: it reads the same with cv2 and imageio hidden as with
    them, through the port's decoder both times; its luma is ffmpeg's bit
    for bit and its RGB too."""
    path = str(tmp_path / "cv2.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (48, 32))
    for f in _clip(32, 48, 3):
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    rgb, fps, count = _cv2_read(path)
    luma, _, _ = _cv2_read(path, convert_rgb=False)
    with_cv2 = import_video(path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    got = import_video(path)
    np.testing.assert_array_equal(got, with_cv2)
    track = mp4.read_mp4(path)
    assert got.shape == (3, 32, 48, 3) and count == 3 and track.fps == fps == 8
    for p, y in zip(mpeg4.decode(track.config, track.samples), luma):
        np.testing.assert_array_equal(p[0], np.asarray(y).reshape(32, 48))
    np.testing.assert_array_equal(got, np.stack(rgb)[..., ::-1])


def test_export_without_cv2_or_imageio(tmp_path, monkeypatch):
    """No writer of cv2 or imageio runs: with both hidden the export writes
    the mp4 (QP 5 at quality 9) and the PNG frames, padded to 8."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    frames = _clip(32, 48, 5)
    path = export_to_video(frames, str(tmp_path / "o" / "orbit.mp4"), fps=8)
    assert h264.quality_to_qp(9) == 5
    got = import_video(path)
    assert got.shape == (8, 32, 48, 3)
    np.testing.assert_array_equal(got[5:], np.repeat(got[4:5], 3, axis=0))
    enc = h264.encode(frames + [frames[-1]] * 3, 5, 8)
    np.testing.assert_array_equal(got, np.stack([h264.to_rgb(*r) for r in enc.recon]))
    np.testing.assert_array_equal(import_video(str(tmp_path / "o" / "frames"))[:5], frames)
    with pytest.raises(ValueError, match="odd side"):
        h264.encode([np.zeros((31, 48, 3), np.uint8)], 5, 8)


def test_moov_after_mdat_and_unknown_boxes(tmp_path, good):
    """A file laid out ftyp, free, mdat, an unknown box, moov reads the same
    samples; the co64 chunk table is written past 4 GiB and read back."""
    ftyp = mp4.box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomavc1")
    free = mp4.box(b"free", bytes(13))
    head = len(ftyp) + len(free) + 8
    offsets = [head + sum(len(s) for s in good.samples[:i]) for i in range(len(good.samples))]
    mdat = mp4.box(b"mdat", *good.samples)
    moov = mp4._moov(good.sps, good.pps, 48, 64, 8, [len(s) for s in good.samples], offsets)
    path = tmp_path / "late.mp4"
    path.write_bytes(ftyp + free + mdat + mp4.box(b"zzzz", b"?") + moov)
    track = mp4.read_mp4(str(path))
    assert track.samples == good.samples and (track.width, track.height, track.fps) == (48, 64, 8)
    wide = mp4._moov(good.sps, good.pps, 48, 64, 8, [10, 10], [5 << 32, (5 << 32) + 10])
    assert b"co64" in wide and b"stco" not in wide
    path.write_bytes(ftyp + wide)
    with pytest.raises(ValueError, match="sample 0 .* past the end of the file"):
        mp4.read_mp4(str(path))


def _damaged(blob, rnd, n_cuts=60, n_flips=120):
    for cut in sorted(set(rnd.randint(1, len(blob), n_cuts).tolist())):
        yield "cut", blob[:cut]
    for _ in range(n_flips):
        b = bytearray(blob)
        for pos in rnd.randint(0, len(b), rnd.randint(1, 4)):
            b[pos] ^= 1 << rnd.randint(8)
        yield "flip", bytes(b)


def test_damaged_files_raise_or_decode(tmp_path, good):
    """Truncations raise a ValueError naming a box or the stream; bit flips
    either decode to pictures of the clip's size or raise a ValueError. The
    streams: `good` (an IDR and a P picture, the filter on) and a P stream
    of three references, mixed sub-partitions, two-row slices and the
    filter's offsets."""
    inter = h264.encode(_clip(64, 48, 5, seed=4), 30, 8, slice_rows=2, refs=3,
                        partition="mixed", filter_offsets=(2, -1))
    for name, enc in (("good", good), ("inter", inter)):
        src = _write(tmp_path / f"{name}.mp4", enc, 48, 64)
        blob = open(src, "rb").read()
        rnd = np.random.RandomState(11)
        path = tmp_path / "bad.mp4"
        raised = decoded = 0
        for kind, data in _damaged(blob, rnd):
            path.write_bytes(data)
            try:
                frames = read_mp4(str(path))
            except ValueError:
                raised += 1
                continue
            assert kind == "flip" and frames.ndim == 4 and frames.shape[-1] == 3
            decoded += 1
        total = len(list(_damaged(blob, np.random.RandomState(11))))
        assert raised > 60 and raised + decoded == total
