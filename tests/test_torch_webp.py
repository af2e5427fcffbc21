"""The port's WebP decoder (hi3d_tpu_torch/utils/webp.py) against cv2's
`imdecode(..., IMREAD_UNCHANGED)` (OpenCV's libwebp), bit for bit: lossy
(VP8) files of qualities 1–100 and sizes 1×1 to 517×389, from cv2, from PIL
and from libwebp's own encoder set to the simple and the normal loop
filter, every sharpness, 1 to 8 token partitions, 1 to 4 segments;
lossless (VP8L) files with every transform, colour caches and palettes of
2 to 200 colours; alpha as cv2's and libwebp's encoders write it and in
hand-built ALPH chunks of each compression and filter; grey input (3
channels back, as cv2); the readers that take WebPs now (load_image_rgb,
the folder and tar datasets, serve's input glob) against the JAX
package's; animated files (PIL's, libwebp's muxer: lossy, lossless, with
alpha, a first frame smaller than the canvas; and hand-built frames at
offsets, with and without the alpha flag), whose first frame cv2 reads;
malformed, truncated and corrupted files.

tests/data/torch_webp/ holds the committed fixtures (the chip smoke decodes
them on a machine without cv2; asset1.webp is main path 4's second serve
input) and goldens.json, the shape and SHA-256 of cv2's decode of each as
RGB(A). `python tests/test_torch_webp.py` writes them again.
"""

import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import tarfile

import numpy as np
import pytest

import torch_threads  # noqa: F401
import cv2
from test_torch_jpeg import _demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "torch_webp")
SIZES = [(1, 1), (2, 3), (5, 4), (7, 9), (16, 16), (17, 33), (31, 30), (100, 77), (389, 517)]


# ------------------------------------------------ libwebp's encoder (PIL's)

class _Config(ctypes.Structure):  # libwebp's WebPConfig (encode.h, ABI 0x020f)
    _fields_ = [("lossless", ctypes.c_int), ("quality", ctypes.c_float),
                ("method", ctypes.c_int), ("image_hint", ctypes.c_int),
                ("target_size", ctypes.c_int), ("target_PSNR", ctypes.c_float)] + [
        (n, ctypes.c_int) for n in (
            "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
            "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass_",
            "show_compressed", "preprocessing", "partitions", "partition_limit",
            "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
            "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")]


class _Picture(ctypes.Structure):  # WebPPicture
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int), ("y", ctypes.c_void_p),
                ("u", ctypes.c_void_p), ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
                ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2)]


class _Writer(ctypes.Structure):  # WebPMemoryWriter
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


_libwebp = None


def libwebp_encode(rgb, quality=75.0, **config):
    """libwebp's WebPEncode (the copy PIL ships) of RGB or RGBA `rgb` with
    WebPConfig fields set that neither cv2 nor PIL exposes: filter_type,
    filter_sharpness, partitions, segments, alpha_filtering, ..."""
    global _libwebp
    if _libwebp is None:
        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        for dep in glob.glob(os.path.join(libs, "libsharpyuv*")):
            ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
        _libwebp = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*"))[0])
    lib, abi = _libwebp, 0x020F
    rgb = np.ascontiguousarray(rgb, np.uint8)
    cfg, pic, out = _Config(), _Picture(), _Writer()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), abi)
    for k, v in config.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), config
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    pic.height, pic.width = rgb.shape[:2]
    pic.use_argb = cfg.lossless
    load = lib.WebPPictureImportRGBA if rgb.shape[2] == 4 else lib.WebPPictureImportRGB
    assert load(ctypes.byref(pic), rgb.ctypes.data_as(ctypes.c_void_p), rgb.shape[1] * rgb.shape[2])
    lib.WebPMemoryWriterInit(ctypes.byref(out))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.pointer(out), ctypes.c_void_p)
    try:
        assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), pic.error_code
        return ctypes.string_at(out.mem, out.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(out))


# ------------------------------------------------------ files built here

def cv2_webp(img, quality):
    """cv2's WebP of a BGR(A) or grey image (quality above 100: lossless)."""
    ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return buf.tobytes()


def chunk(kind, body):
    return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def riff(*chunks):
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(w, h, flags=0x10):
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def filter_alpha(a, method):
    """libwebp's alpha filters forward (0 none, 1 horizontal, 2 vertical,
    3 gradient): the residual of each sample from its prediction."""
    a = a.astype(int)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif method == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    else:
        pred[:] = 0
    return ((a - pred) & 255).astype(np.uint8)


def alpha_webp(bgr, alpha, compression, method, quality=70):
    """A hand-built VP8X + ALPH + VP8 file: cv2's lossy VP8 chunk of `bgr`
    and `alpha` filtered by `method`, stored raw (compression 0) or as the
    green of a headerless VP8L stream (compression 1, cut from cv2's
    lossless WebP of the filtered plane)."""
    h, w = alpha.shape
    vp8 = cv2_webp(bgr, quality)[12:]
    assert vp8[:4] == b"VP8 "
    plane = filter_alpha(alpha, method)
    if compression == 0:
        payload = plane.tobytes()
    else:
        green = np.zeros((h, w, 3), np.uint8)
        green[..., 1] = plane
        lossless = cv2_webp(green, 101)
        assert lossless[12:16] == b"VP8L"
        payload = lossless[20 + 5:20 + int.from_bytes(lossless[16:20], "little")]
    return riff(vp8x(w, h), chunk(b"ALPH", bytes([compression | method << 2]) + payload), vp8)


def _alpha_plane(h, w, seed):
    """A horizontal ramp with noise, opaque in its top half."""
    rnd = np.random.RandomState(seed)
    a = np.clip(rnd.randint(-40, 40, (h, w)) + np.linspace(0, 255, w)[None], 0, 255)
    a[: h // 2] = 255
    return a.astype(np.uint8)


def _palette_image(h, w, n, seed):
    rnd = np.random.RandomState(seed)
    return rnd.randint(0, 256, (n, 3)).astype(np.uint8)[rnd.randint(0, n, (h, w))]


def serve_asset():
    """Main path 4's second input: demo/3.png rolled by a quarter of its
    width, its near-white background transparent, as a lossy WebP with
    alpha."""
    img = np.roll(cv2.imread(os.path.join(ROOT, "demo", "3.png"), cv2.IMREAD_COLOR), 128, axis=1)
    alpha = np.where((img > 235).all(-1), 0, 255).astype(np.uint8)
    return cv2_webp(np.concatenate([img, alpha[..., None]], -1), 85)


def pil_anim(frames, lossless, quality=80):
    """PIL's animated WebP (libwebp's WebPAnimEncoder) of RGB(A) frames."""
    from PIL import Image

    ims = [Image.fromarray(np.ascontiguousarray(f)) for f in frames]
    out = io.BytesIO()
    ims[0].save(out, "WEBP", save_all=True, append_images=ims[1:], lossless=lossless,
                quality=quality, duration=100)
    return out.getvalue()


def anmf(x, y, w, h, frame):
    """An ANMF chunk: the frame's chunks (ALPH, VP8 or VP8L) at (x, y),
    its size as given, 100 ms, blending on."""
    return chunk(b"ANMF", b"".join(v.to_bytes(3, "little") for v in
                                   (x // 2, y // 2, w - 1, h - 1, 100)) + b"\0" + frame)


def image_chunks(blob):
    """A still WebP's ALPH, VP8 and VP8L chunks, as a frame holds them."""
    return b"".join(chunk(k, b) for k, b in _chunks(blob) if k in (b"ALPH", b"VP8 ", b"VP8L"))


def animated(canvas, frames, flags=0x12):
    """An animated WebP of (x, y, still WebP) frames on a (w, h) canvas."""
    anim = [anmf(x, y, *_vp8_dims(still), image_chunks(still)) for x, y, still in frames]
    return riff(vp8x(*canvas, flags), chunk(b"ANIM", bytes(6)), *anim)


def _vp8_dims(still):
    h, w = cv2.imdecode(np.frombuffer(still, np.uint8), cv2.IMREAD_UNCHANGED).shape[:2]
    return w, h


def _anim_frames(h, w, alpha=False, seed=0):
    """Three RGB(A) frames: demo/3.png, its negative and a shifted copy,
    the alpha transparent at the top and left edges (which libwebp's muxer
    crops from the first frame)."""
    rgb = _demo(h, w, seed)[..., ::-1]
    frames = [rgb, 255 - rgb, np.roll(rgb, 3, 1)]
    if not alpha:
        return frames
    a = _alpha_plane(h, w, seed)
    a[: h // 5] = 0
    a[:, : w // 6] = 0
    return [np.concatenate([f, a[..., None]], -1) for f in frames]


FIXTURES = {
    "lossy_q75_389x517.webp": lambda: cv2_webp(_demo(389, 517), 75),
    "lossy_q5_1x1.webp": lambda: cv2_webp(_demo(1, 1), 5),
    "lossy_simple_sharp5_parts4_45x61.webp": lambda: libwebp_encode(
        _demo(45, 61)[..., ::-1], 60, filter_type=0, filter_strength=70, filter_sharpness=5,
        partitions=2, segments=4),
    "grey_q90_29x37.webp": lambda: cv2_webp(_demo(29, 37)[..., 1], 90),
    "lossless_61x47.webp": lambda: cv2_webp(_demo(61, 47), 101),
    "lossless_palette3_29x37.webp": lambda: cv2_webp(_palette_image(29, 37, 3, 1), 101),
    "alpha_q80_48x64.webp": lambda: cv2_webp(
        np.concatenate([_demo(48, 64), _alpha_plane(48, 64, 2)[..., None]], -1), 80),
    "alpha_raw_gradient_17x33.webp": lambda: alpha_webp(_demo(17, 33), _alpha_plane(17, 33, 3),
                                                        0, 3),
    "alpha_vp8l_vertical_31x29.webp": lambda: alpha_webp(_demo(31, 29),
                                                         _alpha_plane(31, 29, 4), 1, 2),
    "asset1.webp": serve_asset,
    # animated (cv2 reads the first frame): PIL's, its first frame cropped to
    # 50×32 at (6, 8) by the muxer; lossless; hand-built frames at offsets,
    # without the alpha flag; demo/3.png at 512², the chip smoke's timing
    "anim_lossy_alpha_56x40.webp": lambda: pil_anim(_anim_frames(40, 56, True), False),
    "anim_lossless_61x47.webp": lambda: pil_anim(_anim_frames(47, 61), True),
    "anim_offsets_64x48.webp": lambda: animated((64, 48), [
        (10, 6, alpha_webp(_demo(21, 35), _alpha_plane(21, 35, 6), 1, 1)),
        (28, 26, cv2_webp(_demo(21, 35), 101))], flags=0x02),
    "anim_512.webp": lambda: pil_anim([cv2.imread(os.path.join(ROOT, "demo", "3.png"))[..., ::-1],
                                       cv2.imread(os.path.join(ROOT, "demo", "3.png"))[::-1]],
                                      False, 75),
}


def cv2_rgb(blob):
    """cv2's decode as RGB(A)."""
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    return np.ascontiguousarray(want[..., [2, 1, 0, 3][:want.shape[-1]]])


def golden(img):
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def write_fixtures():
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    goldens = {}
    for name, make in FIXTURES.items():
        blob = make()
        with open(os.path.join(FIXTURE_DIR, name), "wb") as f:
            f.write(blob)
        goldens[name] = golden(cv2_rgb(blob))
    with open(os.path.join(FIXTURE_DIR, "goldens.json"), "w") as f:
        json.dump(goldens, f, indent=1, sort_keys=True)


def _same(blob, label=""):
    from hi3d_tpu_torch.utils.webp import decode_webp

    got, want = decode_webp(blob), cv2_rgb(blob)
    assert got.dtype == np.uint8 and got.shape == want.shape, label
    np.testing.assert_array_equal(got, want, err_msg=label)
    return got


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("group", [0, 1, 2])
def test_lossy_matches_cv2(group):
    """cv2's lossy WebPs, qualities 1–100, sizes 1×1 to 517×389, and PIL's
    at every method (0–6): bit-equal, 3 channels."""
    from PIL import Image

    for i, (h, w) in enumerate(SIZES[group::3]):
        img = _demo(h, w, seed=i)
        for q in ((1, 30, 60, 90, 100) if h < 100 else (10, 95)):
            assert _same(cv2_webp(img, q), f"{h}x{w} q{q}").shape == (h, w, 3)
    big = Image.fromarray(_demo(389, 517, seed=9)[..., ::-1].copy())
    for m in range(group, 7, 3):
        out = io.BytesIO()
        big.save(out, "WEBP", quality=60, method=m)
        _same(out.getvalue(), f"PIL method {m}")


@pytest.mark.parametrize("filter_type", [0, 1])
def test_encoder_settings_match_cv2(filter_type):
    """libwebp's encoder with the simple (0) or normal (1) loop filter at
    sharpness 0, 3 and 7, 1, 2, 4 and 8 token partitions, 1 and 4
    segments; filter strength 0, autofilter and sharp YUV: bit-equal."""
    img = _demo(77, 93, seed=7)[..., ::-1]
    for sharp in (0, 3, 7):
        for parts in (0, 1, 2, 3):
            for seg in (1, 4):
                blob = libwebp_encode(img, 50 + 10 * parts, filter_type=filter_type,
                                      filter_strength=60, filter_sharpness=sharp,
                                      partitions=parts, segments=seg)
                _same(blob, f"sharpness {sharp}, partitions {1 << parts}, segments {seg}")
    for extra in ({"filter_strength": 0}, {"autofilter": 1}, {"use_sharp_yuv": 1}):
        _same(libwebp_encode(img, 40, filter_type=filter_type, **extra), str(extra))


def test_lossless_matches_cv2():
    """Lossless WebPs: cv2's, PIL's at every method and quality (predictor,
    cross-colour and subtract-green transforms, colour caches, meta prefix
    codes), palettes of 2 to 200 colours (pixel bundling at 2, 4 and 16),
    near-lossless and grey input: bit-equal."""
    from PIL import Image

    for i, (h, w) in enumerate(SIZES):
        _same(cv2_webp(_demo(h, w, seed=i), 101), f"{h}x{w}")
    pil = Image.fromarray(_demo(389, 517, seed=5)[..., ::-1].copy())
    for m in range(7):
        out = io.BytesIO()
        pil.save(out, "WEBP", lossless=True, quality=50 + 8 * m, method=m)
        _same(out.getvalue(), f"PIL method {m}")
    for n in (2, 3, 4, 11, 16, 17, 200):
        _same(cv2_webp(_palette_image(61, 47, n, n), 101), f"{n} colours")
    for nl in (0, 60):
        _same(libwebp_encode(_demo(77, 93)[..., ::-1], 70, lossless=1, near_lossless=nl),
              f"near-lossless {nl}")
    grey = _demo(29, 37)[..., 1]
    for q in (50, 101):
        assert _same(cv2_webp(grey, q), f"grey q{q}").shape == (29, 37, 3)


def test_alpha_matches_cv2():
    """Alpha: cv2's lossy and lossless RGBA WebPs, libwebp's with alpha
    compression 0 and 1, filtering none, fast and best and alpha quality
    below 100 (level preprocessing), and hand-built ALPH chunks of every
    compression and filter: bit-equal, 4 channels."""
    for i, (h, w) in enumerate(SIZES[:-1]):
        rgba = np.concatenate([_demo(h, w, seed=i), _alpha_plane(h, w, i)[..., None]], -1)
        for q in (30, 90, 101):
            assert _same(cv2_webp(rgba, q), f"{h}x{w} q{q}").shape == (h, w, 4)
    rgba = np.concatenate([_demo(77, 93)[..., ::-1], _alpha_plane(77, 93, 1)[..., None]], -1)
    for comp in (0, 1):
        for filt in (0, 1, 2):
            for aq in (100, 60):
                _same(libwebp_encode(rgba, 50, alpha_compression=comp, alpha_filtering=filt,
                                     alpha_quality=aq), f"compression {comp} filtering {filt}")
    for comp in (0, 1):
        for method in range(4):
            _same(alpha_webp(_demo(37, 45), _alpha_plane(37, 45, method), comp, method),
                  f"ALPH compression {comp} filter {method}")


def test_container_variants_match_cv2():
    """VP8X files around a lossy or a lossless image with ICC, EXIF, XMP
    and unknown chunks before and after it, an ALPH chunk without the alpha
    flag, the flag without an ALPH chunk (opaque alpha), a VP8L image under
    an ALPH chunk (ignored) and trailing bytes after the RIFF data:
    bit-equal to cv2, channels included."""
    img = _demo(23, 31, seed=3)
    vp8 = cv2_webp(img, 60)[12:]
    vp8l = cv2_webp(img, 101)[12:]
    alph = _chunks(alpha_webp(img, _alpha_plane(23, 31, 5), 1, 2))[1][1]
    extra = [chunk(b"ICCP", bytes(range(40))), chunk(b"ABCD", b"xyz")]
    after = [chunk(b"EXIF", b"Exif\0\0" + bytes(9)), chunk(b"XMP ", b"<x/>")]
    variants = {
        "ICC, unknown, EXIF, XMP": riff(vp8x(31, 23, 0x20 | 0x08 | 0x04), *extra, vp8, *after),
        "ALPH without the flag": riff(vp8x(31, 23, 0), chunk(b"ALPH", alph), vp8),
        "the flag without ALPH": riff(vp8x(31, 23, 0x10), vp8),
        "VP8L in VP8X": riff(vp8x(31, 23, 0), *extra, vp8l, *after),
        "VP8L under ALPH": riff(vp8x(31, 23, 0x10), chunk(b"ALPH", alph), vp8l),
        "trailing bytes": cv2_webp(img, 60) + bytes(range(50)),
    }
    for label, blob in variants.items():
        _same(blob, label)


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (40, 56), (100, 77)])
def test_animated_matches_cv2(size):
    """Animated files: cv2 (WebPAnimDecoder) gives the first frame on its
    canvas, RGBA when the VP8X alpha flag is set, else RGB; the port gives
    the same bytes for PIL's animations (lossy and lossless, RGB and RGBA,
    transparent edges cropped by the muxer) and for hand-built frames at
    offsets on a larger canvas (lossy, lossy with raw or compressed ALPH,
    lossless with alpha), the alpha flag on or off, unknown chunks around
    them, and a frame size in the ANMF chunk that the bitstream overrides."""
    h, w = size
    for alpha in (False, True):
        for lossless in (False, True):
            _same(pil_anim(_anim_frames(h, w, alpha, seed=h), lossless),
                  f"PIL {size} alpha {alpha} lossless {lossless}")
    img = _demo(h, w, seed=w)
    stills = {"lossy": cv2_webp(img, 70), "lossless": cv2_webp(img, 101),
              "compressed ALPH": alpha_webp(img, _alpha_plane(h, w, 2), 1, 3),
              "raw ALPH": alpha_webp(img, _alpha_plane(h, w, 2), 0, 1),
              "lossless alpha": cv2_webp(np.concatenate([img, _alpha_plane(h, w, 3)[..., None]],
                                                        -1), 101)}
    cw, ch = w + 14, h + 9
    for label, still in stills.items():
        frame = image_chunks(still)
        for x, y in ((0, 0), (4, 2), (14, 8)):
            for flags in (0x12, 0x02, 0x3E):
                _same(animated((cw, ch), [(x, y, still), (0, 0, still)], flags),
                      f"{label} {size} at {x},{y} flags {flags:#x}")
        _same(riff(vp8x(cw, ch, 0x12), chunk(b"ICCP", bytes(5)), chunk(b"ANIM", bytes(6)),
                   chunk(b"ABCD", b"xyz"), anmf(2, 2, w, h, frame + chunk(b"WXYZ", bytes(2))),
                   chunk(b"EXIF", bytes(4))), f"{label} {size} unknown chunks")
        _same(riff(vp8x(cw, ch, 0x12), chunk(b"ANIM", bytes(6)),
                   anmf(2, 2, w + 3, h + 5, frame)), f"{label} {size} ANMF size overridden")


def test_animated_refusals_and_damage():
    """What libwebp's demuxer refuses raises a ValueError that names it,
    where cv2 fails too: no ANIM before the frames, a frame (the first or a
    later one) past the canvas, an unknown VP8X flag, a short ANIM chunk, a
    VP8 chunk outside the frames, an ALPH chunk before a lossless frame or
    without an image. Cut and corrupted animations decode to cv2's pixels or
    fail where it fails."""
    from hi3d_tpu_torch.utils.webp import decode_webp

    img = _demo(21, 35)
    still = alpha_webp(img, _alpha_plane(21, 35, 1), 1, 3)
    frame, lossless = image_chunks(still), image_chunks(cv2_webp(img, 101))
    alph = chunk(b"ALPH", _chunks(still)[1][1])
    head = [vp8x(64, 48, 0x12), chunk(b"ANIM", bytes(6))]
    cases = [(riff(vp8x(64, 48, 0x12), anmf(0, 0, 35, 21, frame)), "ANMF chunk before its ANIM"),
             (riff(*head, anmf(30, 0, 35, 21, frame)), r"frame 1: 35×21 at \(30, 0\) outside"),
             (riff(*head, anmf(0, 0, 35, 21, frame), anmf(0, 28, 35, 21, frame)),
              r"frame 2: 35×21 at \(0, 28\) outside"),
             (riff(vp8x(64, 48, 0x13), chunk(b"ANIM", bytes(6)), anmf(0, 0, 35, 21, frame)),
              "unknown flags 0x13"),
             (riff(vp8x(64, 48, 0x12), chunk(b"ANIM", bytes(4)), anmf(0, 0, 35, 21, frame)),
              "ANIM chunk of 4 bytes"),
             (riff(*head, anmf(0, 0, 35, 21, frame), frame), "outside its frames"),
             (riff(*head, anmf(0, 0, 35, 21, alph + lossless)), "ALPH chunk before a lossless"),
             (riff(*head, anmf(0, 0, 35, 21, alph)), "ALPH chunk without an image")]
    for blob, match in cases:
        assert cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED) is None, match
        with pytest.raises(ValueError, match=f"bad.webp: .*{match}"):
            decode_webp(blob, "bad.webp")
    rnd = np.random.RandomState(7)
    seen = {"equal": 0, "both fail": 0}
    for blob in (pil_anim(_anim_frames(40, 56, True), False), pil_anim(_anim_frames(40, 56), True)):
        cases = [blob[:4] + struct.pack("<I", cut - 8) + blob[8:cut]
                 for cut in range(40, len(blob), len(blob) // 40)]
        for _ in range(200):
            bad = bytearray(blob)
            for _ in range(rnd.randint(1, 4)):
                bad[rnd.randint(12, len(bad))] = rnd.randint(256)
            cases.append(bytes(bad))
        for bad in cases:
            want = cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_UNCHANGED)
            try:
                got = decode_webp(bad, "bad.webp")
            except ValueError as e:
                assert str(e).startswith("bad.webp: ") and want is None, e
                seen["both fail"] += 1
                continue
            assert want is not None
            np.testing.assert_array_equal(got, want[..., [2, 1, 0, 3][:want.shape[-1]]])
            seen["equal"] += 1
    assert seen["equal"] > 100 and seen["both fail"] > 50, seen


@pytest.mark.parametrize("size,seed", [((9, 130), 3), ((100, 3), 5), ((40, 56), 1)])
def test_cut_alpha_streams_match_cv2(size, seed):
    """An ALPH chunk of a few alpha levels (a palette: libwebp's 8-bit alpha
    path, which lets its last code read past the data) cut at every length,
    the chunk resized: cv2's pixels or a failure where cv2 fails. Past the
    data libwebp's reader gives its window's bits again, not zeros
    (`tail_*` in csrc/webp_decode.c), and the cuts fail there as in cv2."""
    from hi3d_tpu_torch.utils.webp import decode_webp

    h, w = size
    blob = alpha_webp(_demo(h, w), (_alpha_plane(h, w, seed) // 64) * 64, 1, seed % 4)
    chunks = _chunks(blob)
    i = [k for k, _ in chunks].index(b"ALPH")
    for cut in range(2, len(chunks[i][1])):
        bad = riff(*(chunk(k, b[:cut] if j == i else b) for j, (k, b) in enumerate(chunks)))
        want = cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_UNCHANGED)
        try:
            got = decode_webp(bad, "cut.webp")
        except ValueError as e:
            assert want is None, (cut, e)
            continue
        np.testing.assert_array_equal(got, want[..., [2, 1, 0, 3]], err_msg=str(cut))


def test_fixtures_decode_to_their_goldens():
    from hi3d_tpu_torch.utils.webp import read_webp

    with open(os.path.join(FIXTURE_DIR, "goldens.json")) as f:
        goldens = json.load(f)
    assert set(goldens) == set(FIXTURES)
    total = 0
    for name, want in goldens.items():
        path = os.path.join(FIXTURE_DIR, name)
        total += os.path.getsize(path)
        with open(path, "rb") as f:
            assert golden(cv2_rgb(f.read())) == want, name
        assert golden(read_webp(path)) == want, name
    assert total < 100_000


def test_readers_take_webp(tmp_path, monkeypatch):
    """load_image_rgb on lossy, lossless, alpha and grey WebPs is JAX's
    (cv2's) and never calls cv2; the folder dataset and a stage-2 tar shard
    of alpha WebP frames sample what JAX's sample (masks too); serve's
    input glob picks them up."""
    import hi3d_tpu.data.native_loader as native_loader
    from hi3d_tpu.data import video_dataset as jax_vd
    from hi3d_tpu.utils.image import load_image_rgb as jax_load_image_rgb
    from hi3d_tpu_torch.data import video_dataset as vd
    from hi3d_tpu_torch.pipelines.serve import load_images
    from hi3d_tpu_torch.utils import image
    from test_torch_stage2_training import _NoIPP

    monkeypatch.setattr(native_loader, "available", lambda: False)  # JAX side on cv2
    monkeypatch.setattr(image, "_read_cv2", None)  # a cv2 read would fail
    for name in FIXTURES:
        path = os.path.join(FIXTURE_DIR, name)
        np.testing.assert_array_equal(image.load_image_rgb(path), jax_load_image_rgb(path))

    folder = tmp_path / "renders" / "obj0"
    folder.mkdir(parents=True)
    shard = str(tmp_path / "webp.tar")
    with tarfile.open(shard, "w") as tf:
        for i in range(96):
            rgba = np.concatenate([_demo(16, 16, seed=i), _alpha_plane(16, 16, i)[..., None]], -1)
            data = cv2_webp(rgba, 60 + i % 42)
            (folder / f"{i:03d}.webp").write_bytes(data)
            info = tarfile.TarInfo(f"obj0/{i:03d}.webp")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    kw = dict(width=16, height=16, sample_frames=16)
    got = vd.VideoTrainDataset(str(tmp_path / "renders"), **kw).sample(np.random.RandomState(2))
    want = jax_vd.VideoTrainDataset(str(tmp_path / "renders"), **kw).sample(
        np.random.RandomState(2))
    np.testing.assert_array_equal(got["video"].transpose(0, 2, 3, 1), want["video"])
    kw.update(seed=1, process_index=0, process_count=1)
    got = vd.TarShardVideoDatasetStage2(shard, **kw).sample(np.random.RandomState(0))
    with _NoIPP():
        want = jax_vd.TarShardVideoDatasetStage2(shard, **kw).sample(np.random.RandomState(0))
    np.testing.assert_array_equal(got["video"].transpose(0, 2, 3, 1), want["video"])
    np.testing.assert_array_equal(got["masks"], want["masks"])

    images = load_images([str(folder / "000.webp")], (16, 16))
    rgb = image.load_image_rgb(str(folder / "000.webp")).astype(np.float32)
    np.testing.assert_array_equal(images[0], (rgb / 255.0 - 0.5) * 2.0)


def _chunks(blob):
    """The (kind, body) chunks of a WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(blob):
        size = int.from_bytes(blob[pos + 4:pos + 8], "little")
        out.append((blob[pos:pos + 4], blob[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def test_malformed_webps_raise():
    """An animated file without frames, a bad VP8X, a canvas that is not the image's size, a
    bad ALPH header, a lossless header of another version and every
    truncation of a lossy, a lossless and an alpha file raise a ValueError
    that names the file; their bitstreams cut (their chunks resized) or with
    seeded bytes changed decode to cv2's pixels or fail where it fails, and
    never read or write out of bounds."""
    from hi3d_tpu_torch.utils.webp import decode_webp

    lossy = cv2_webp(_demo(21, 35), 70)
    lossless = cv2_webp(_demo(21, 35), 101)
    alpha = alpha_webp(_demo(21, 35), _alpha_plane(21, 35, 0), 1, 3)
    vp8 = lossy[12:]
    # ANIM and ANMF chunks in a file without the animation flag: skipped
    _same(riff(vp8x(35, 21, 0), chunk(b"ANMF", bytes(16)), vp8))
    cases = [
        (riff(vp8x(35, 21, 0x02), chunk(b"ANIM", bytes(6))), "animated WebP without a frame"),
        (riff(chunk(b"VP8X", bytes(8)), vp8), "VP8X chunk of 8 bytes"),
        (riff(vp8x(36, 21, 0), vp8), "canvas of 36×21 around an image of 35×21"),
        (riff(vp8x(35, 21), chunk(b"ALPH", b"\x03" + bytes(8)), vp8), "ALPH chunk with "
         "compression 3"),
        (riff(vp8x(35, 21), chunk(b"ALPH", b"\x00" + bytes(8)), vp8), "raw WebP ALPH chunk"),
        (lossless[:20] + b"\x2e" + lossless[21:], "VP8L chunk without its signature"),
        (riff(chunk(b"ICCP", bytes(16))), "whose first chunk is b'ICCP'"),
        (b"RIFF\x04\x00\x00\x00WEBP" + bytes(20), "RIFF size of 4"),
        (lossless[:31], "WebP of 31 bytes; cv2 reads none under 32"),
        (b"RIFF" + bytes(8), "not a WebP"),
    ]
    for blob, match in cases:
        with pytest.raises(ValueError, match=f"bad.webp: .*{match}"):
            decode_webp(blob, "bad.webp")
    def attempt(blob):  # cv2's result: the same pixels, or both fail
        want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
        try:
            got = decode_webp(blob, "bad.webp")
        except ValueError as e:
            assert str(e).startswith("bad.webp: ") and want is None, e
            return
        assert want is not None
        np.testing.assert_array_equal(got, want[..., [2, 1, 0, 3][:want.shape[-1]]])

    for blob in (lossy, lossless, alpha):
        step = max(1, len(blob) // 60)
        for cut in range(12, len(blob), step):  # the file cut short
            short = blob[:4] + struct.pack("<I", cut - 8) + blob[8:cut]
            with pytest.raises(ValueError, match="bad.webp: "):
                decode_webp(short, "bad.webp")
        chunks = _chunks(blob)
        for i, (kind, body) in enumerate(chunks):  # a bitstream cut, its chunk resized
            if kind in (b"VP8 ", b"VP8L", b"ALPH"):
                for cut in range(2, len(body), step):
                    attempt(riff(*(chunk(k, body[:cut] if j == i else b)
                                   for j, (k, b) in enumerate(chunks))))
        rnd = np.random.RandomState(len(blob))
        for _ in range(150):  # a few bytes of the bitstreams changed
            bad = bytearray(blob)
            for _ in range(rnd.randint(1, 4)):
                bad[rnd.randint(32, len(bad))] = rnd.randint(256)
            attempt(bytes(bad))


if __name__ == "__main__":
    write_fixtures()
