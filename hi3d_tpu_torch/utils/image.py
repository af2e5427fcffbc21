"""Host-side image preprocessing for the CLIs (counterpart of
hi3d_tpu/utils/image.py), on numpy and the port's image decoders.

`read_image`, `decode_image` and `load_image_rgb` tell formats apart by one
signature table (`_FORMATS`), as cv2 does, and decode without cv2 what
cv2's `IMREAD_UNCHANGED` gives, bit for bit: PNG (utils/png.py), JPEG
(utils/jpeg.py), WebP (utils/webp.py), BMP (utils/bmp.py), TIFF
(utils/tiff.py), GIF (utils/gif.py), PNM (utils/pnm.py), PAM
(utils/pam.py) and Sun raster (utils/sunras.py). A format or a variant the
port does not decode (AVIF, JPEG 2000, CCITT TIFF, an arithmetic-coded
JPEG, ...) raises
`Unsupported`, which names it; where cv2 imports, every entry point (and so
the training datasets) hands such a file to cv2 instead, as the JAX
package reads every file. Images cv2 returns as uint16 or float (16-bit
PNG, TIFF and PNM, float TIFF, PFM, Radiance HDR, OpenEXR) raise a
ValueError on every host: the JAX package's / 255 mishandles them.

`remove_background` is the stage-1 CLI's background removal: the port's
U²-Net (`models/u2net.py`) on the caller's device when a checkpoint is
found, else the `rembg` package when it imports, else the input unchanged.

`resize_bilinear_u8` follows cv2.resize's INTER_LINEAR sampling (half-pixel
centres, edge clamp) in floating point; cv2 itself rounds through 11-bit
fixed-point weights, so the two agree to within one grey level, and exactly
when the size does not change.

`resize_bicubic_u8` is PIL's antialiased BICUBIC `Image.resize` in integer
arithmetic, bit for bit: the eval set's preprocessing
(data/video_dataset.prepare_eval_input). `log_txt_as_img` renders the image
logger's caption images with the bitmap font of utils/font.py.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

from .bmp import decode_bmp, is_bmp
from .gif import decode_gif, is_gif
from .jpeg import decode_jpeg, is_jpeg
from .pam import decode_pam, is_pam
from .png import _SIGNATURE as _PNG_SIGNATURE
from .png import decode_png, write_png
from .pnm import decode_pnm, is_pnm
from .raster import Unsupported
from .sunras import decode_sunras, is_sunras
from .tiff import decode_tiff
from .webp import decode_webp, is_webp

_FLOAT = object()  # formats cv2 returns as float32

# (format, signature test, decoder); None: a format the port does not decode
_FORMATS = (
    ("PNG", lambda b: b.startswith(_PNG_SIGNATURE), decode_png),
    ("JPEG", is_jpeg, decode_jpeg),
    ("WebP", is_webp, decode_webp),
    ("BMP", is_bmp, decode_bmp),
    ("TIFF", lambda b: b[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"), decode_tiff),
    ("GIF", is_gif, decode_gif),
    ("PNM", is_pnm, decode_pnm),
    ("PAM", is_pam, decode_pam),
    ("Sun raster", is_sunras, decode_sunras),
    ("AVIF", lambda b: b[4:8] == b"ftyp" and b[8:12] in (b"avif", b"avis"), None),
    ("JPEG 2000", lambda b: b.startswith(b"\x00\x00\x00\x0cjP  \r\n\x87\n") or
     b.startswith(b"\xff\x4f\xff\x51"), None),
    ("PFM", lambda b: b[:2] in (b"PF", b"Pf") and b[2:3].isspace(), _FLOAT),
    ("Radiance HDR", lambda b: b.startswith((b"#?RADIANCE", b"#?RGBE")), _FLOAT),
    ("OpenEXR", lambda b: b[:4] == b"\x76\x2f\x31\x01", _FLOAT),
)


def center_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    th, tw = size
    h, w = img.shape[:2]
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return img[i : i + th, j : j + tw]


def composite_white(rgba: np.ndarray) -> np.ndarray:
    """RGBA uint8 → RGB uint8 on a white background."""
    rgb = rgba[..., :3].astype(np.float32)
    a = rgba[..., 3:4].astype(np.float32) / 255.0
    out = rgb * a + 255.0 * (1.0 - a)
    return out.round().astype(np.uint8)


def _decode(blob: bytes, name: str, from_file: bool) -> np.ndarray:
    """The port's decode of an encoded image, by its signature; a JPEG
    from a file as cv2.imread reads it (to an EOI its libjpeg source
    supplies at the end of the file)."""
    for fmt, test, decode in _FORMATS:
        if not test(blob):
            continue
        if decode is None:
            raise Unsupported(f"{name}: a {fmt} image, which the port does not decode")
        if decode is _FLOAT:
            raise ValueError(f"{name}: a {fmt} image, which cv2 returns as float32 and the JAX "
                             "package's / 255 mishandles; the port reads 8-bit images only")
        if decode is decode_jpeg:
            return decode_jpeg(blob, name, from_file=from_file)
        return decode(blob, name)
    raise Unsupported(f"{name}: an image format the port does not know (it starts "
                      f"{blob[:8]!r})")


def _from_cv2(img: Optional[np.ndarray], name: str, why: str) -> np.ndarray:
    """cv2's IMREAD_UNCHANGED decode as the port's: uint8 (H, W, C) RGB(A);
    `why` the port's reason for asking cv2."""
    if img is None:
        raise ValueError(f"{why}; cv2 cannot decode it either")
    if img.dtype != np.uint8:
        raise ValueError(f"{name}: cv2 decodes it as {img.dtype}, which the JAX package's "
                         "/ 255 mishandles; the port reads 8-bit images only")
    if img.ndim == 2:
        return img[..., None]
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[-1]]])  # BGR(A) → RGB(A)


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _read_cv2(path: str, why: str) -> Optional[np.ndarray]:
    """cv2.imread of a file the port does not decode, as `_from_cv2`
    gives it; None where cv2 does not import."""
    cv2 = _cv2()
    if cv2 is None:
        return None
    try:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    except cv2.error:  # past its size limits
        img = None
    return _from_cv2(img, path, why)


def _decode_cv2(blob: bytes, name: str, why: str) -> Optional[np.ndarray]:
    """cv2.imdecode, as `_read_cv2`."""
    cv2 = _cv2()
    if cv2 is None:
        return None
    try:
        img = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED) if blob else None
    except cv2.error:  # past its size limits
        img = None
    return _from_cv2(img, name, why)


def decode_image(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """An encoded image → uint8 (H, W, C), C = 1-4, RGB(A) order, as
    `cv2.imdecode(..., IMREAD_UNCHANGED)` gives it: the port's decoders,
    else cv2 for what they do not decode (`Unsupported`, raised where cv2
    does not import)."""
    try:
        return _decode(blob, name, from_file=False)
    except Unsupported as e:
        img = _decode_cv2(blob, name, str(e))
        if img is None:
            raise
        return img


def read_image(path: str) -> np.ndarray:
    """`decode_image` of a file, as cv2.imread reads it."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        return _decode(blob, path, from_file=True)
    except Unsupported as e:
        img = _read_cv2(path, str(e))
        if img is None:
            raise
        return img


def load_image_rgb(path: str) -> np.ndarray:
    """uint8 HWC RGB (`read_image`); RGBA is composited onto white, gray is
    replicated."""
    img = read_image(path)
    if img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)
    if img.shape[-1] == 2:  # gray + alpha
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], -1)
    if img.shape[-1] == 4:
        return composite_white(img)
    return img


def _linear_taps(n_in: int, n_out: int):
    """cv2 INTER_LINEAR source index/weight pairs along one axis."""
    scale = n_in / n_out
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(f)
    frac = f - i0
    i0 = i0.astype(np.int64)
    frac = np.where(i0 < 0, 0.0, frac)
    i0 = np.clip(i0, 0, n_in - 1)
    frac = np.where(i0 >= n_in - 1, 0.0, frac)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, frac


def resize_bilinear_u8(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC → uint8 (size_wh[1], size_wh[0], C), cv2.resize argument order."""
    w_out, h_out = size_wh
    h, w = img.shape[:2]
    if (h, w) == (h_out, w_out):
        return img.copy()
    y0, y1, fy = _linear_taps(h, h_out)
    x0, x1, fx = _linear_taps(w, w_out)
    src = img.astype(np.float64)
    rows = src[y0] * (1.0 - fy)[:, None, None] + src[y1] * fy[:, None, None]
    out = rows[:, x0] * (1.0 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point resampling coefficients


def _bicubic_weights(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic kernel, a = -0.5."""
    x = np.abs(x)
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _bicubic_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's `precompute_coeffs` and `normalize_coeffs_8bpc` for BICUBIC along
    one axis: (source index, fixed-point weight), each (n_out, taps). The
    support widens by the reduction factor (antialiasing); weights past a
    pixel's window are 0."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    x = np.arange(taps)
    w = _bicubic_weights((x[None, :] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where(x[None, :] < count[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    return np.minimum(xmin[:, None] + x[None, :], n_in - 1), fixed


def _bicubic_pass(img: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    """One 8-bit resampling pass of PIL's: integer sums from a half-unit
    start, shifted and clipped to uint8."""
    idx, k = _bicubic_taps(img.shape[axis], n_out)
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    tail = (1,) * (src.ndim - 1)
    for j in range(k.shape[1]):
        acc += src[idx[:, j]] * k[:, j].reshape((-1,) + tail)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic_u8(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W, 3|4) → (size_wh[1], size_wh[0], C), bit-equal to PIL's
    `Image.resize(size_wh, Image.BICUBIC)` on an RGB or RGBA image: RGBA is
    resized premultiplied (PIL's RGBA → RGBa → resize → RGBA, with its
    rounding both ways), the horizontal pass runs first and only an axis
    whose size changes is resampled."""
    w, h = size_wh
    if img.shape[:2] == (h, w):
        return img.copy()
    rgba = img.shape[-1] == 4
    if rgba:
        t = img[..., :3].astype(np.uint32) * img[..., 3:].astype(np.uint32) + 128
        img = np.concatenate([(((t >> 8) + t) >> 8).astype(np.uint8), img[..., 3:]], -1)
    if img.shape[1] != w:
        img = _bicubic_pass(img, 1, w)
    if img.shape[0] != h:
        img = _bicubic_pass(img, 0, h)
    if rgba:
        a = img[..., 3:].astype(np.int64)
        rgb = img[..., :3].astype(np.int64)
        straight = np.clip(255 * rgb // np.maximum(a, 1), 0, 255)
        rgb = np.where((a == 0) | (a == 255), rgb, straight).astype(np.uint8)
        img = np.concatenate([rgb, img[..., 3:]], -1)
    return img


def log_txt_as_img(wh: Tuple[int, int], captions, size: int = 10) -> np.ndarray:
    """Captions as white images with black text (the JAX package's
    `log_txt_as_img`): (B, H, W, 3) float32 in [-1, 1], text from (0, 0),
    wrapped every max(int(40·W/256), 1) characters, a list caption taking
    its first element. The glyphs are utils/font.py's bitmap font at
    `size` px, laid out on DejaVu Sans's line metrics; they are not PIL's
    glyphs, but each line's text falls on the same rows."""
    from .font import render_lines

    w, h = wh
    nc = max(int(40 * (w / 256)), 1)
    out = []
    for cap in captions:
        if isinstance(cap, (list, tuple)):
            cap = cap[0]
        cap = str(cap)
        ink = np.zeros((h, w), bool)
        render_lines(ink, [cap[i:i + nc] for i in range(0, len(cap), nc)], size)
        img = np.where(ink, -1.0, 1.0).astype(np.float32)
        out.append(np.repeat(img[..., None], 3, axis=-1))
    return np.stack(out)


def resize_center_crop(img: np.ndarray, resolution: Tuple[int, int]) -> np.ndarray:
    """Resize so the target fits, then center crop (reference :137-141)."""
    h, w = img.shape[:2]
    rate = max(resolution[0] / h, resolution[1] / w)
    img = resize_bilinear_u8(img, (math.ceil(w * rate), math.ceil(h * rate)))
    return center_crop(img, resolution)


def foreground_mask_from_white(img: np.ndarray, threshold: int = 220) -> np.ndarray:
    """Float (H, W) mask: 0 where every channel exceeds `threshold`
    (near-white background), 1 elsewhere."""
    bg = np.all(img.astype(np.int32) > threshold, axis=-1)
    return (~bg).astype(np.float32)


def _u2net_checkpoint() -> Optional[str]:
    """A U²-Net checkpoint: $HI3D_U2NET_CKPT, else ckpts/u2net.pth, else
    ckpts/u2netp.pth; None when none exists."""
    cand = [os.environ.get("HI3D_U2NET_CKPT", "")]
    cand += [os.path.join("ckpts", n) for n in ("u2net.pth", "u2netp.pth")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    return None


def _write_rgba_outputs(rgb: np.ndarray, alpha: np.ndarray, out_rgba: str,
                        out_white: str) -> str:
    """Write the RGBA cut-out and its white composite as PNGs; returns the
    white one's path."""
    a = np.clip(alpha * 255.0, 0, 255).round().astype(np.uint8)
    rgba = np.concatenate([rgb, a[..., None]], axis=-1)
    write_png(out_rgba, rgba)
    write_png(out_white, composite_white(rgba))
    return out_white


def remove_background(path: str, out_rgba: str, out_white: str, device="cuda") -> str:
    """Background removal (reference pipeline_i2v_eval_v01.py:153-168).

    With a U²-Net checkpoint (`_u2net_checkpoint`) the port's U²-Net runs on
    `device`; without one the `rembg` package runs if it imports; otherwise
    the input is taken to have a clean background already. Returns the path
    of the white-background image the pipeline reads."""
    ckpt = _u2net_checkpoint()
    if ckpt is not None:
        import torch

        from ..convert import load_u2net
        from ..models.u2net import U2Net, segment

        sd, full = load_u2net(ckpt)
        with torch.device("meta"):
            model = U2Net(full=full)
        model = model.to_empty(device=device)
        model.load_state_dict(sd, strict=True)
        img = load_image_rgb(path)
        mask = segment(model.eval(), img).cpu().numpy()
        return _write_rgba_outputs(img, mask, out_rgba, out_white)

    try:
        import rembg
        from PIL import Image
    except ImportError:
        return path
    image = rembg.remove(Image.open(path), session=rembg.new_session())
    image.save(out_rgba)
    white = Image.new("RGB", image.size, "WHITE")
    white.paste(image, mask=image.split()[3])
    white.save(out_white)
    return out_white
