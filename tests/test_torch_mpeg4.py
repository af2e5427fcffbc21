"""The port's MPEG-4 Part 2 reader (hi3d_tpu_torch/utils/mpeg4.py,
csrc/mpeg4_decode.c, the `mp4v` sample entry of utils/mp4.py and
utils/video.read_mp4) against libavcodec's decoder through cv2.

- cv2's own `mp4v` files (cv2.VideoWriter, as the JAX package's
  `export_to_video` writes where imageio has no ffmpeg plugin) at 48×32,
  100×60, 256² and 512² of noise, smooth motion, still frames and a fast
  pan, 1 to 32 frames: the port's luma is bit-equal to cv2's
  (CAP_PROP_CONVERT_RGB 0 gives the Y plane), its RGB bit-equal to cv2's
  (libswscale's yuv420p → BGR24, which h264.to_rgb ports), its frame count
  and fps cv2's.
- Streams cv2's writer cannot be asked for, written by tests/torch_mpeg4.py
  (AC prediction, dquant with AC rescaling, the DC as a coefficient under
  intra_dc_vlc_thr, every TCOEF escape, four vectors a macroblock,
  vop_fcode_forward 1-3, stuffing): luma bit-equal to cv2's.
- The committed fixtures of tests/data/torch_mp4v/ against their goldens
  (with jax, hi3d_tpu, cv2 and imageio blocked, as on the card's host).
- The user's path: JAX's stage 1 writes first_step/first.mp4 through cv2;
  the port's `v2v.prepare_inputs` (cv2 and imageio hidden) reads it as
  JAX's does, and `full`'s reading of a JAX-written second.mp4.
- Refusals by name (h264.Unsupported) of every tool outside the subset,
  and damaged files (a ValueError or cv2's decode, never a crash).

`python tests/test_torch_mpeg4.py` writes the fixtures and goldens again.
"""

import hashlib
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

import torch_mpeg4 as tm
import torch_threads  # noqa: F401
from hi3d_tpu.pipelines import v2v as jax_v2v
from hi3d_tpu.utils.video import export_to_video as jax_export_to_video
from hi3d_tpu.utils.video import import_video as jax_import_video
from hi3d_tpu_torch.pipelines.v2v import prepare_inputs
from hi3d_tpu_torch.utils import h264, mp4, mpeg4
from hi3d_tpu_torch.utils.png import write_png
from hi3d_tpu_torch.utils.video import import_video, read_mp4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "torch_mp4v")

_log = getattr(getattr(cv2, "utils", None), "logging", None)
if _log is not None:  # errors only: each raw Y-plane read warns otherwise
    _log.setLogLevel(_log.LOG_LEVEL_ERROR)


def _demo(h, w):
    img = cv2.imread(os.path.join(ROOT, "demo", "3.png"), cv2.IMREAD_COLOR)[..., ::-1]
    return np.ascontiguousarray(cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))


def _smooth(h, w, t):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([128 + 100 * np.sin(xx / 13.0 + t) * np.cos(yy / 7.0),
                     128 + 90 * np.cos(xx / 5.0 + yy / 11.0 + t / 3),
                     xx * 255.0 / w], -1).clip(0, 255).astype(np.uint8)


def clip(content, h, w, n, seed=0):
    """`n` RGB frames: noise (smooth frames whose middle quarter is a new
    random colour with noise each frame: libavcodec codes frames of noise
    alone as I-VOPs, and this is what gives intra macroblocks in P-VOPs),
    smooth (drifting sinusoids), still (one frame of demo/3.png) or pan
    (demo/3.png rolled w/8 pixels a frame)."""
    if content == "noise":
        rnd = np.random.RandomState(seed)
        frames = [_smooth(h, w, 0.3 * i) for i in range(n)]
        r0, r1, c0, c1 = h // 4, 3 * h // 4, w // 4, 3 * w // 4
        for f in frames:
            patch = rnd.randint(0, 256, (1, 1, 3)) + rnd.randint(-12, 13, (r1 - r0, c1 - c0, 3))
            f[r0:r1, c0:c1] = patch.clip(0, 255)
        return frames
    if content == "smooth":
        return [_smooth(h, w, 0.3 * i) for i in range(n)]
    base = _demo(h, w)
    if content == "still":
        return [base] * n
    return [np.roll(base, i * max(2, w // 8), axis=1) for i in range(n)]


def cv2_write(path, frames, fps=8):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    return str(path)


def cv2_read(path, convert_rgb=True):
    """cv2's frames (RGB, or the Y plane with convert_rgb off), fps and
    frame count."""
    cap = cv2.VideoCapture(str(path))
    if not convert_rgb:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(f[..., ::-1]) if convert_rgb else np.asarray(f).copy())
    cap.release()
    return frames, fps, count


def port_planes(path, stats=None):
    track = mp4.read_mp4(str(path))
    assert track.codec == "mp4v"
    return mpeg4.decode(track.config, track.samples, os.path.basename(str(path)), stats)


def _digest(img):
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def check_against_cv2(path, stats=None):
    """The port's luma and RGB bit-equal to cv2's, its frame count and fps
    cv2's."""
    planes = port_planes(path, stats)
    luma, fps, count = cv2_read(path, convert_rgb=False)
    rgb, _, _ = cv2_read(path)
    track = mp4.read_mp4(str(path))
    assert len(planes) == len(luma) == len(rgb) == count == len(track.samples)
    assert track.fps == fps
    for i, (p, y) in enumerate(zip(planes, luma)):
        assert np.array_equal(p[0], y), f"frame {i}: luma differs from cv2's"
    ours = read_mp4(str(path))
    np.testing.assert_array_equal(ours, np.stack([h264.to_rgb(*p) for p in planes]))
    np.testing.assert_array_equal(ours, np.stack(rgb))


# ------------------------------------------------------------ fixtures

# name: (content, height, width, frames); first.mp4 and second_1024.mp4 go
# through JAX's export_to_video (cv2's mp4v here), syntax_96x64.mp4 is
# tests/torch_mpeg4.random_stream (seed 0) for the tools cv2 does not write,
# the rest go through cv2
FIXTURES = {
    "first.mp4": ("pan", 512, 512, 16),  # JAX's stage-1 file: a 16-frame orbit at 512²
    "second_1024.mp4": ("pan", 1024, 1024, 16),  # the size of a JAX second.mp4
    "noise_48x32.mp4": ("noise", 32, 48, 13),  # intra macroblocks in P-VOPs, across a GOP
    "pan_100x60.mp4": ("pan", 60, 100, 13),  # vectors past the edge, not whole macroblocks
    "still_100x60.mp4": ("still", 60, 100, 12),  # not_coded macroblocks
    "syntax_96x64.mp4": ("syntax", 64, 96, 13),  # every tool of the subset
}
# the tools each small fixture is there for (utils/mpeg4.STATS)
FIXTURE_TOOLS = {"noise_48x32.mp4": ("intra_in_p",), "pan_100x60.mp4": ("past_edge",),
                 "still_100x60.mp4": ("not_coded",), "syntax_96x64.mp4": mpeg4.STATS}


def make_fixture(name, path):
    content, h, w, n = FIXTURES[name]
    if content == "syntax":
        tm.write_mp4v(path, *tm.random_stream(w, h, n, 0), w, h)
        return
    frames = clip(content, h, w, n)
    if name in ("first.mp4", "second_1024.mp4"):
        saved = sys.modules.get("imageio")
        sys.modules["imageio"] = None  # as on a host whose imageio has no ffmpeg plugin
        try:
            assert jax_export_to_video(frames, path, fps=8) == path
        finally:
            if saved is None:
                del sys.modules["imageio"]
            else:
                sys.modules["imageio"] = saved
    else:
        cv2_write(path, frames)


def golden(path):
    """Per frame: cv2's luma and RGB."""
    luma, fps, _ = cv2_read(path, convert_rgb=False)
    rgb, _, _ = cv2_read(path)
    return {"fps": fps, "frames": [{"luma": _digest(y), "rgb": _digest(r)}
                                   for y, r in zip(luma, rgb)]}


def write_fixtures():
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    goldens = {}
    for name in FIXTURES:
        path = os.path.join(FIXTURE_DIR, name)
        make_fixture(name, path)
        goldens[name] = golden(path)
    with open(os.path.join(FIXTURE_DIR, "goldens.json"), "w") as f:
        json.dump(goldens, f, indent=1, sort_keys=True)


def _goldens():
    with open(os.path.join(FIXTURE_DIR, "goldens.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_matches_its_golden_and_cv2(name):
    """The committed file decodes to its goldens (cv2's luma and RGB, bit
    for bit) and, cv2 here, to cv2's decode; each small fixture exercises
    its tool."""
    path = os.path.join(FIXTURE_DIR, name)
    want = _goldens()[name]
    stats = {}
    planes = port_planes(path, stats)
    assert len(planes) == len(want["frames"]) == FIXTURES[name][3]
    assert mp4.read_mp4(path).fps == want["fps"] == 8
    for p, g in zip(planes, want["frames"]):
        assert _digest(np.ascontiguousarray(p[0])) == g["luma"]
        assert _digest(h264.to_rgb(*p)) == g["rgb"]
    check_against_cv2(path)
    for tool in FIXTURE_TOOLS.get(name, ()):
        assert stats[tool] > 0, (tool, stats)
    assert stats["P"] > 0 and stats["I"] + stats["P"] == FIXTURES[name][3]


def test_fixtures_decode_without_jax_cv2_or_imageio():
    """As on the card's host: with jax, hi3d_tpu, cv2 and imageio blocked,
    import_video reads every fixture to its goldens."""
    code = f"""
import sys
for name in ("jax", "hi3d_tpu", "cv2", "imageio"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
import hashlib, json, os
from hi3d_tpu_torch.utils.video import import_video
folder = {FIXTURE_DIR!r}
with open(os.path.join(folder, "goldens.json")) as f:
    goldens = json.load(f)
for name, want in goldens.items():
    frames = import_video(os.path.join(folder, name))
    assert len(frames) == len(want["frames"]), name
    for f, g in zip(frames, want["frames"]):
        assert hashlib.sha256(f.tobytes()).hexdigest() == g["rgb"]["sha256"], name
print("ok")
"""
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().endswith("ok")


# -------------------------------------------------- cv2's own streams

CV2_STREAMS = [("noise", 32, 48, 13), ("noise", 256, 256, 1), ("smooth", 32, 48, 12),
               ("smooth", 256, 256, 32), ("still", 60, 100, 12), ("still", 512, 512, 12),
               ("pan", 60, 100, 32), ("pan", 512, 512, 13)]
STREAM_TOOLS = {"noise": "intra_in_p", "still": "not_coded", "pan": "past_edge",
                "smooth": "round_down"}


@pytest.mark.parametrize("content,h,w,n", CV2_STREAMS)
def test_cv2_streams_match_cv2(tmp_path, content, h, w, n):
    path = cv2_write(tmp_path / f"{content}.mp4", clip(content, h, w, n, seed=h + n))
    stats = {}
    check_against_cv2(path, stats)
    assert stats["I"] + stats.get("P", 0) == n
    if n > 1:
        assert stats["P"] > 0 and stats[STREAM_TOOLS[content]] > 0, stats


# ------------------------------------------- streams cv2 cannot write

RANDOM_SIZES = [(48, 32), (96, 64), (100, 60), (64, 48)]


@pytest.mark.parametrize("seed", range(8))
def test_random_syntax_streams_match_cv2(tmp_path, seed):
    """tests/torch_mpeg4.random_stream: every tool of the subset at random;
    the port's luma is cv2's bit for bit."""
    w, h = RANDOM_SIZES[seed % 4]
    config, samples = tm.random_stream(w, h, 9, seed)
    path = tm.write_mp4v(str(tmp_path / "r.mp4"), config, samples, w, h)
    planes = port_planes(path)
    luma, fps, count = cv2_read(path, convert_rgb=False)
    assert len(planes) == len(luma) == count == 9 and fps == 8
    for i, (p, y) in enumerate(zip(planes, luma)):
        assert np.array_equal(p[0], y), f"frame {i}: luma differs from cv2's"


def test_random_streams_cover_every_tool():
    stats = {}
    for seed in range(8):
        w, h = RANDOM_SIZES[seed % 4]
        config, samples = tm.random_stream(w, h, 9, seed)
        mpeg4.decode(config, samples, "random", stats)
    for tool in mpeg4.STATS:
        assert stats[tool] > 0, (tool, stats)


def test_in_band_headers(tmp_path):
    """The VOS, VO and VOL again in-band before each I-VOP (as libavcodec
    writes them without a global header) read as cv2 reads them; with no
    DecoderSpecificInfo in the esds at all (which cv2 cannot open) the
    in-band headers alone give the same decode."""
    config, samples = tm.random_stream(48, 32, 9, 3)
    samples = [config + s if i % 4 == 0 else s for i, s in enumerate(samples)]
    path = tm.write_mp4v(str(tmp_path / "inband.mp4"), config, samples, 48, 32)
    planes = port_planes(path)
    luma, _, _ = cv2_read(path, convert_rgb=False)
    assert len(planes) == len(luma) == 9
    for p, y in zip(planes, luma):
        np.testing.assert_array_equal(p[0], y)
    bare = tm.write_mp4v(str(tmp_path / "bare.mp4"), b"", samples, 48, 32)
    assert mp4.read_mp4(bare).config == b""
    for p, q in zip(port_planes(bare), planes):
        np.testing.assert_array_equal(p[0], q[0])


# ------------------------------------------------------ the user's path

def test_jax_stage1_file_reads_in_v2v(tmp_path, monkeypatch):
    """JAX's export_to_video writes first_step/first.mp4 through cv2's
    mp4v (imageio without its ffmpeg plugin cannot); with cv2 and imageio
    hidden the port's v2v.prepare_inputs reads it as JAX's does (through
    cv2): frames and masks equal."""
    res, clip_size = 64, 12
    frames = clip("pan", res, res, 14)
    for f in frames:  # a white border, so that the masks have both classes
        f[:6] = 255
    monkeypatch.setitem(sys.modules, "imageio", None)
    path = str(tmp_path / "first_step" / "first.mp4")
    assert jax_export_to_video(frames, path, fps=8) == path
    assert mp4.read_mp4(path).codec == "mp4v"
    clean = str(tmp_path / "clean.png")
    write_png(clean, frames[0])
    want, want_masks = jax_v2v.prepare_inputs(clean, path, clip_size, (res, res))
    theirs = np.stack(jax_import_video(path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours = import_video(path)
    assert ours.shape == theirs.shape == (16, res, res, 3)  # padded to 2 s at fps 8
    np.testing.assert_array_equal(ours, theirs)
    got, got_masks = prepare_inputs(clean, path, clip_size, (res, res))
    assert got.shape == want.shape == (clip_size, res, res, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_masks, want_masks)


def test_jax_second_mp4_reads_as_full_reads_it(tmp_path, monkeypatch):
    """`full` reads the first clip_size frames of second.mp4 for its
    ViewScorer (the port's full.py and JAX's, import_video(second_mp4,
    max_frames=clip_size)): a JAX-written 128² second.mp4 reads the same
    bit for bit with cv2 and imageio hidden."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    path = str(tmp_path / "second_step_video" / "second.mp4")
    jax_export_to_video(clip("pan", 128, 128, 16), path, fps=8)
    theirs = np.stack(jax_import_video(path, max_frames=12))
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours = import_video(path, max_frames=12)
    assert ours.shape == theirs.shape == (12, 128, 128, 3)
    np.testing.assert_array_equal(ours, theirs)


# ---------------------------------------------------------- refusals

def _vol_stream(**tools):
    w = tm.Bits()
    tm.vop_header(w, 0, 3, 8)
    w.stuff()
    return tm.vos_vo() + tm.vol(48, 32, verid=2, **tools), [w.bytes()]


def _vop_stream(kind=0, coded=1):
    config, samples = tm.random_stream(48, 32, 1, 0)
    w = tm.Bits()
    tm.vop_header(w, kind, 3, 8, fcode=1, coded=coded)
    w.stuff()
    return config, samples + [w.bytes()]


REFUSALS = {
    "interlace": (lambda: _vol_stream(interlaced=1), "interlace"),
    "obmc": (lambda: _vol_stream(obmc=1), "OBMC"),
    "sprite": (lambda: _vol_stream(sprite=1), "sprites"),
    "gmc": (lambda: _vol_stream(sprite=2), "GMC"),
    "not_8_bit": (lambda: _vol_stream(not_8_bit=1), "more than 8 bits"),
    "mpeg_quant": (lambda: _vol_stream(quant_type=1), "MPEG quantisation"),
    "quarter_sample": (lambda: _vol_stream(quarter_sample=1), "quarter-sample"),
    "complexity": (lambda: _vol_stream(complexity=1), "complexity estimation"),
    "resync": (lambda: _vol_stream(resync=1), "resync markers"),
    "data_partitioned": (lambda: _vol_stream(data_partitioned=1), "data partitioning$"),
    "reversible_vlc": (lambda: _vol_stream(data_partitioned=1, reversible_vlc=1),
                       "reversible VLC"),
    "newpred": (lambda: _vol_stream(newpred=1), "NEWPRED"),
    "reduced_resolution": (lambda: _vol_stream(reduced_resolution=1), "reduced resolution"),
    "scalability": (lambda: _vol_stream(scalability=1), "scalability"),
    "shape": (lambda: _vol_stream(shape=1), "non-rectangular shape"),
    "chroma_422": (lambda: _vol_stream(chroma_format=2), "chroma_format 2"),
    "b_vop": (lambda: _vop_stream(kind=2), "a B-VOP"),
    "s_vop": (lambda: _vop_stream(kind=3), r"an S\(GMC\)-VOP"),
    "n_vop": (lambda: _vop_stream(coded=0), r"an N-VOP \(vop_coded 0\)"),
    "xvid": (lambda: (tm.vos_vo() + tm.vol(48, 32) + b"\x00\x00\x01\xb2XviD0050",
                      tm.random_stream(48, 32, 1, 0)[1]), "XviD"),
    "packed": (lambda: (lambda c, s: (c, [s[0] + s[1][s[1].index(b"\x00\x00\x01\xb6"):]]))(
        *tm.random_stream(48, 32, 2, 0)), "2 packed VOPs"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_tools_outside_the_subset_are_refused(tmp_path, monkeypatch, case):
    make, words = REFUSALS[case]
    config, samples = make()
    path = tm.write_mp4v(str(tmp_path / f"{case}.mp4"), config, samples, 48, 32)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(h264.Unsupported, match=words):
        import_video(path)


def test_mp4v_entry_of_another_codec_is_refused(tmp_path, monkeypatch):
    config, samples = tm.random_stream(48, 32, 2, 0)
    path = tm.write_mp4v(str(tmp_path / "m2v.mp4"), config, samples, 48, 32, object_type=0x61)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(h264.Unsupported,
                       match=r"objectTypeIndication 0x61 \(MPEG-2 video \(Main profile\)\)"):
        import_video(path)


def test_refused_stream_is_read_through_cv2_where_it_imports(tmp_path, monkeypatch):
    """A stream under MPEG quantisation (default matrices), which cv2
    decodes: the port refuses it and import_video hands it to cv2 (imageio
    hidden, as here it has no ffmpeg plugin)."""
    config, samples = tm.random_stream(48, 32, 5, 0, quant_type=1)
    path = tm.write_mp4v(str(tmp_path / "mpeg_quant.mp4"), config, samples, 48, 32)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(h264.Unsupported):
        read_mp4(path)
    want, _, _ = cv2_read(path)
    np.testing.assert_array_equal(import_video(path), np.stack(want))


# ------------------------------------------------------------ damage

def _damaged(blob, rnd, n_cuts=40, n_flips=120, start=0):
    for cut in sorted(set(rnd.randint(start + 1, len(blob), n_cuts).tolist())):
        yield "cut", blob[:cut]
    for _ in range(n_flips):
        b = bytearray(blob)
        for pos in rnd.randint(start, len(b), rnd.randint(1, 4)):
            b[pos] ^= 1 << rnd.randint(8)
        yield "flip", bytes(b)


def test_damaged_samples_raise_or_decode_as_cv2(tmp_path):
    """Truncated samples and flipped bits in the VOP data raise a
    ValueError or decode; a decode that raises nothing is cv2's luma."""
    src = os.path.join(FIXTURE_DIR, "noise_48x32.mp4")
    track = mp4.read_mp4(src)
    rnd = np.random.RandomState(7)
    raised = decoded = 0
    for i in (0, 3):
        head = track.samples[i].index(b"\x00\x00\x01\xb6") + 4
        for kind, data in _damaged(track.samples[i], rnd, 20, 60, start=head):
            samples = list(track.samples)
            samples[i] = data
            path = tm.write_mp4v(str(tmp_path / "bad.mp4"), track.config, samples, 48, 32)
            try:
                planes = port_planes(path)
            except ValueError:
                raised += 1
                continue
            decoded += 1
            luma, _, _ = cv2_read(path, convert_rgb=False)
            for p, y in zip(planes, luma):
                np.testing.assert_array_equal(p[0], y)
    assert raised > 40 and decoded > 0


def test_damaged_files_raise_or_decode(tmp_path):
    """Cuts and flips anywhere in the file (boxes, esds, headers) raise a
    ValueError naming a box or the stream, or decode to frames of the
    clip's size."""
    blob = open(os.path.join(FIXTURE_DIR, "pan_100x60.mp4"), "rb").read()
    rnd = np.random.RandomState(11)
    path = tmp_path / "bad.mp4"
    raised = 0
    for kind, data in _damaged(blob, rnd):
        path.write_bytes(data)
        try:
            frames = read_mp4(str(path))
        except ValueError:
            raised += 1
            continue
        assert frames.ndim == 4 and frames.shape[-1] == 3
    assert raised > 40


@pytest.mark.parametrize("esds,match", [
    (b"\x00\x00\x00\x00\x03", "cut in its size"),
    (b"\x00\x00\x00\x00\x04\x05", "descriptor tag 4, want 3"),
    (b"\x00\x00\x00\x00\x03\x80\x80\x80\x80\x05", "runs past 4 bytes"),
    (b"\x00\x00\x00\x00\x03\x7f\x00\x01\x00", "runs past its parent"),
    (b"\x00\x00\x00\x00\x03\x05\x00\x01\x00\x04\x00", "DecoderConfigDescriptor of 0 bytes"),
])
def test_malformed_esds_raises_naming_it(tmp_path, esds, match):
    blob = open(os.path.join(FIXTURE_DIR, "still_100x60.mp4"), "rb").read()
    at = blob.index(b"esds") - 4
    size = int.from_bytes(blob[at:at + 4], "big")
    new = (8 + len(esds)).to_bytes(4, "big") + b"esds" + esds
    delta = len(new) - size
    out = bytearray(blob[:at] + new + blob[at + size:])
    # the boxes that hold the esds grow with it (moov/trak/mdia/minf/stbl/stsd/mp4v)
    for kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"stsd", b"mp4v"):
        k = bytes(out).index(kind) - 4
        out[k:k + 4] = (int.from_bytes(out[k:k + 4], "big") + delta).to_bytes(4, "big")
    path = tmp_path / "esds.mp4"
    path.write_bytes(bytes(out))
    with pytest.raises(ValueError, match=match) as caught:
        mp4.read_mp4(str(path))
    assert "esds" in str(caught.value) and not isinstance(caught.value, h264.Unsupported)


if __name__ == "__main__":
    write_fixtures()
