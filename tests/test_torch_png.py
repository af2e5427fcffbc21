"""The port's PNG reader (hi3d_tpu_torch/utils/png.py) against cv2's
`imdecode(..., IMREAD_UNCHANGED)` (libpng), bit for bit: Adam7-interlaced
images of every colour type and of palettes, grey at 1, 2 and 4 bits (with
and without tRNS), and RGB with a tRNS key colour, which libpng turns into
alpha (png_set_tRNS_to_alpha) and the port now does too; the readers that
see such files (load_image_rgb, the folder and tar datasets, the eval set)
against the JAX package's; malformed and truncated files.

tests/data/torch_png/ holds the committed fixtures (the chip smoke decodes
them on a machine without cv2) and goldens.json, the shape and SHA-256 of
cv2's decode of each in the port's layout. `python tests/test_torch_png.py`
writes them again with `FIXTURES`' settings.
"""

import hashlib
import io
import json
import os
import struct
import tarfile
import zlib

import numpy as np
import pytest

import torch_threads  # noqa: F401
import cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "torch_png")
SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# name: (height, width, bit depth, colour type, interlace, tRNS)
FIXTURES = {
    "rgb_trns_23x17.png": (23, 17, 8, 2, 0, True),
    "adam7_rgb_trns_33x17.png": (33, 17, 8, 2, 1, True),
    "adam7_rgba_29x31.png": (29, 31, 8, 6, 1, False),
    "adam7_grey_alpha_9x7.png": (9, 7, 8, 4, 1, False),
    "adam7_palette4_trns_17x33.png": (17, 33, 4, 3, 1, True),
    "adam7_grey2_7x9.png": (7, 9, 2, 0, 1, False),
    "grey1_trns_13x21.png": (13, 21, 1, 0, 0, True),
    "grey4_31x29.png": (31, 29, 4, 0, 0, False),
}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples, depth):
    """(h, w, ch) samples → (h, stride) bytes, sub-byte depths MSB first."""
    h, w, ch = samples.shape
    if depth < 8:
        bits = (samples[..., :1] >> np.arange(depth - 1, -1, -1)) & 1
        return np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)
    return samples.reshape(h, w * ch).astype(np.uint8)


def _filter(rows, bpp, rnd):
    """Each row under a random filter type (0 None … 4 Paeth)."""
    out = b""
    prev = np.zeros(rows.shape[1], int)
    for row in rows.astype(int):
        left = np.concatenate([np.zeros(bpp, int), row[:-bpp]])[:row.size]
        upleft = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])[:row.size]
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        f = rnd.randint(5)
        pred = (0, left, prev, (left + prev) // 2, paeth)[f]
        out += bytes([f]) + ((row - pred) & 255).astype(np.uint8).tobytes()
        prev = row
    return out


def encode_png(samples, depth, ctype, interlace=0, plte=None, trns=None, seed=0):
    """A PNG of (h, w, ch) samples as stored, each pass's rows under random
    filters."""
    h, w, ch = samples.shape
    rnd = np.random.RandomState(seed)
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), max(1, depth * ch // 8), rnd)
    blob = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                   interlace))
    if plte is not None:
        blob += _chunk(b"PLTE", plte)
    if trns is not None:
        blob += _chunk(b"tRNS", trns)
    return blob + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def make_png(h, w, depth, ctype, interlace, trns, seed=0):
    """demo/3.png at (h, w) with seeded noise, quantised to `depth` bits (a
    palette image: random colours), with a tRNS chunk when asked: an RGB
    key on the colour of a few pixels, a grey key, or half the palette."""
    from test_torch_jpeg import _demo

    rnd = np.random.RandomState(seed)
    img = _demo(h, w, seed)[..., ::-1]
    ch = CHANNELS[ctype]
    if ctype == 3:
        samples = rnd.randint(0, 1 << depth, (h, w, 1))
    elif ctype in (0, 4):
        grey = img[..., 1:2] >> (8 - depth)
        samples = np.concatenate([grey, rnd.randint(0, 256, (h, w, 1))], -1)[..., :ch]
    else:
        samples = np.concatenate([img, rnd.randint(0, 256, (h, w, 1))], -1)[..., :ch]
    plte = key = None
    if ctype == 3:
        plte = rnd.randint(0, 256, 3 << depth).astype(np.uint8).tobytes()
        if trns:
            key = rnd.randint(0, 256, max(1, (1 << depth) // 2)).astype(np.uint8).tobytes()
    elif trns and ctype == 2:
        samples[rnd.rand(h, w) < 0.2] = samples[0, 0]
        key = struct.pack(">HHH", *(int(v) for v in samples[0, 0]))
    elif trns:
        key = struct.pack(">H", int(samples[0, 0, 0]))
    return encode_png(samples, depth, ctype, interlace, plte, key, seed)


def cv2_layout(blob):
    """cv2's decode in the port's layout: RGB(A), grey as (H, W, 1), grey +
    alpha as (H, W, 2) (cv2 gives it as BGRA)."""
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    if want.ndim == 2:
        return want[..., None]
    if blob[25] == 4:
        return np.ascontiguousarray(want[..., [0, 3]])
    return np.ascontiguousarray(want[..., [2, 1, 0, 3][:want.shape[-1]]])


def golden(img):
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def write_fixtures():
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    goldens = {}
    for name, spec in FIXTURES.items():
        blob = make_png(*spec)
        with open(os.path.join(FIXTURE_DIR, name), "wb") as f:
            f.write(blob)
        goldens[name] = golden(cv2_layout(blob))
    with open(os.path.join(FIXTURE_DIR, "goldens.json"), "w") as f:
        json.dump(goldens, f, indent=1, sort_keys=True)


KINDS = [(1, 0), (2, 0), (4, 0), (8, 0), (8, 2), (8, 4), (8, 6), (1, 3), (2, 3), (4, 3), (8, 3)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("depth,ctype", KINDS)
def test_decode_matches_cv2(depth, ctype, interlace):
    """Every colour type and depth, Adam7 or not, with and without tRNS, at
    1×1, 2×3, 7×9 and 33×17 (passes of no pixels) and 517×389 (8-bit RGB):
    bit-equal to cv2's libpng."""
    from hi3d_tpu_torch.utils.png import decode_png

    sizes = [(1, 1), (2, 3), (7, 9), (33, 17)] + ([(389, 517)] if (depth, ctype) == (8, 2)
                                                  else [])
    for i, (h, w) in enumerate(sizes):
        for trns in ((False, True) if ctype in (0, 2, 3) else (False,)):
            blob = make_png(h, w, depth, ctype, interlace, trns, seed=i)
            got, want = decode_png(blob), cv2_layout(blob)
            assert got.dtype == np.uint8 and got.shape == want.shape, (h, w, trns)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} tRNS {trns}")
            if trns and ctype == 2:  # alpha 0 on exactly the key's pixels
                assert got.shape[-1] == 4 and (got[..., 3] == 0).any()


def test_fixtures_decode_to_their_goldens():
    from hi3d_tpu_torch.utils.png import read_png

    with open(os.path.join(FIXTURE_DIR, "goldens.json")) as f:
        goldens = json.load(f)
    assert set(goldens) == set(FIXTURES)
    total = 0
    for name, want in goldens.items():
        path = os.path.join(FIXTURE_DIR, name)
        total += os.path.getsize(path)
        with open(path, "rb") as f:
            assert golden(cv2_layout(f.read())) == want, name
        assert golden(read_png(path)) == want, name
    assert total < 30_000


def test_fixtures_load_as_in_jax(monkeypatch):
    """load_image_rgb on every fixture (Adam7, 1/2/4-bit grey, tRNS) is
    JAX's, and never calls cv2."""
    from hi3d_tpu.utils.image import load_image_rgb as jax_load_image_rgb
    from hi3d_tpu_torch.utils import image

    monkeypatch.setattr(image, "_read_cv2", None)  # a cv2 read would fail
    for name in FIXTURES:
        path = os.path.join(FIXTURE_DIR, name)
        np.testing.assert_array_equal(image.load_image_rgb(path), jax_load_image_rgb(path))


def _rgb_trns(h, w, seed):
    return make_png(h, w, 8, 2, seed % 2, True, seed)


def test_rgb_trns_loads_as_in_jax(tmp_path, monkeypatch):
    """An RGB PNG with a tRNS key (the fault: the port returned the raw RGB,
    255 away from JAX's white where the key is): load_image_rgb,
    rgba_white_from_bytes (image and mask), a folder dataset and a stage-2
    tar shard (masks) as the JAX package's; a grey PNG with tRNS stays
    grey."""
    import hi3d_tpu.data.native_loader as native_loader
    from hi3d_tpu.data import video_dataset as jax_vd
    from hi3d_tpu.utils.image import load_image_rgb as jax_load_image_rgb
    from hi3d_tpu_torch.data import video_dataset as vd
    from hi3d_tpu_torch.utils.image import decode_image, load_image_rgb
    from test_torch_stage2_training import _NoIPP

    monkeypatch.setattr(native_loader, "available", lambda: False)  # JAX side on cv2
    for name in ("rgb_trns_23x17.png", "adam7_rgb_trns_33x17.png", "grey1_trns_13x21.png"):
        path = os.path.join(FIXTURE_DIR, name)
        np.testing.assert_array_equal(load_image_rgb(path), jax_load_image_rgb(path))
        with open(path, "rb") as f:
            blob = f.read()
        want_rgb, want_mask = jax_vd.rgba_white_from_bytes(blob)
        img = decode_image(blob, name)
        np.testing.assert_array_equal(vd.rgba_white(img), want_rgb)
        if img.shape[-1] == 4:
            np.testing.assert_array_equal(img[..., 3:].astype(np.float32) / 255.0, want_mask)
        else:
            assert (want_mask == 1).all()
        h, w = img.shape[:2]
        np.testing.assert_array_equal(vd.alpha_mask(img, (w, h)),
                                      (want_mask[..., 0] > 0.5).astype(np.float32))

    folder = tmp_path / "renders" / "obj0"
    folder.mkdir(parents=True)
    for i in range(96):
        (folder / f"{i:03d}.png").write_bytes(_rgb_trns(16, 16, i))
    kw = dict(width=16, height=16, sample_frames=16)
    got = vd.VideoTrainDataset(str(tmp_path / "renders"), **kw).sample(np.random.RandomState(2))
    want = jax_vd.VideoTrainDataset(str(tmp_path / "renders"), **kw).sample(
        np.random.RandomState(2))
    np.testing.assert_array_equal(got["video"].transpose(0, 2, 3, 1), want["video"])

    shard = str(tmp_path / "trns.tar")
    with tarfile.open(shard, "w") as tf:
        for i in range(96):
            data = _rgb_trns(16, 16, i)
            info = tarfile.TarInfo(f"obj0/{i:03d}.png")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    kw = dict(width=16, height=16, sample_frames=16, seed=1, process_index=0, process_count=1)
    got = vd.TarShardVideoDatasetStage2(shard, **kw).sample(np.random.RandomState(0))
    with _NoIPP():
        want = jax_vd.TarShardVideoDatasetStage2(shard, **kw).sample(np.random.RandomState(0))
    np.testing.assert_array_equal(got["video"].transpose(0, 2, 3, 1), want["video"])
    np.testing.assert_array_equal(got["masks"], want["masks"])
    assert (got["masks"] == 0).any()


def test_eval_input_reads_rgb_trns_as_pil(tmp_path):
    """The eval set reads with PIL in the JAX package, which opens an RGB
    PNG with tRNS as mode RGB (the key kept as info["transparency"], no
    alpha): prepare_eval_input gives JAX's values, with and without a
    crop."""
    from PIL import Image

    from hi3d_tpu.data.video_dataset import prepare_eval_input as jax_prepare
    from hi3d_tpu_torch.data.video_dataset import prepare_eval_input

    path = tmp_path / "eval.png"
    path.write_bytes(_rgb_trns(37, 29, 3))
    with Image.open(path) as im:
        assert im.mode == "RGB" and "transparency" in im.info
    for crop in (-1, 20):
        want = jax_prepare(str(path), 10.0, crop, 48)
        got = prepare_eval_input(str(path), 10.0, crop, 48)
        np.testing.assert_array_equal(got["input_image"], want["input_image"])


def test_malformed_pngs_raise():
    """A 16-bit PNG, an unknown interlace method, a chunk running past the
    end, a short IHDR, corrupt or short image data, a critical chunk with a
    bad CRC or of an unknown kind, a missing IEND and bytes that are no PNG
    raise a ValueError that names the file, where libpng fails; an
    ancillary chunk with a bad CRC is dropped, as libpng drops it."""
    from hi3d_tpu_torch.utils.png import decode_png

    good = make_png(7, 9, 8, 2, 1, True)
    ihdr = struct.unpack(">IIBBBBB", good[16:29])
    idat = good.index(b"IDAT") - 4
    rest = good[33:]

    def with_ihdr(*fields):
        return SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", *fields)) + rest

    raw = zlib.decompress(good[idat + 8:good.index(b"IEND") - 8])
    cases = [
        (with_ihdr(9, 7, 16, 2, 0, 0, 0), "bit depth 16"),
        (with_ihdr(*ihdr[:6], 2), "interlace 2"),
        (good[:60], "truncated PNG"),
        (SIGNATURE + _chunk(b"IHDR", good[16:28]) + rest, "header of 12 bytes"),
        (with_ihdr(9, 8, *ihdr[2:]), "PNG data size"),
        (with_ihdr(0, 7, *ihdr[2:]), "0×7 pixels"),
        (good[:idat] + _chunk(b"IDAT", zlib.compress(raw)[:-9]) + good[good.index(b"IEND") - 4:],
         "corrupt PNG image data"),
        (good[:idat] + _chunk(b"IDAT", bytes(20)) + good[good.index(b"IEND") - 4:],
         "corrupt PNG image data"),
        (good[:-1] + bytes([good[-1] ^ 1]), "IEND' chunk with a bad CRC"),
        (good[:idat + 20] + bytes([good[idat + 20] ^ 1]) + good[idat + 21:],
         "IDAT' chunk with a bad CRC"),
        (good[:idat] + _chunk(b"ZZZZ", b"") + good[idat:], "unknown critical PNG chunk"),
        (good[:-12], "no IEND chunk"),
        (b"GIF89a" + bytes(20), "not a PNG"),
    ]
    for blob, match in cases:
        with pytest.raises(ValueError, match=f"bad.png: .*({match})"):
            decode_png(blob, "bad.png")
    trns = good.index(b"tRNS") - 4
    dropped = good[:trns + 14] + bytes([good[trns + 14] ^ 1]) + good[trns + 15:]
    want = cv2_layout(dropped)
    assert decode_png(dropped).shape == want.shape == (7, 9, 3)
    np.testing.assert_array_equal(decode_png(dropped), want)


if __name__ == "__main__":
    write_fixtures()
