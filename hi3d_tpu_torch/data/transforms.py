"""Image transforms on numpy HWC arrays without cv2 or PIL (counterpart of
hi3d_tpu/data/transforms.py:1-483, the reference's vendored
`opencv_transforms`).

Every function and class of the JAX module, with its numpy HWC inputs and
outputs and its `rng: np.random.Generator` draws in the same order; where
the JAX module calls cv2 or PIL, this module computes what they compute:

- `resize` (cv2.resize): the per-axis weights of `degradation.resize_weights`
  (cv2's INTER_NEAREST, LINEAR, CUBIC, AREA and LANCZOS4 taps, float32
  arithmetic for the tap positions). A float image is resampled in float64
  and rounded once to its dtype. uint8 goes through cv2's fixed-point
  weights, each rounded to 1/2048 (INTER_RESIZE_COEF_BITS 11), summed as
  integers and rounded half up at the end; INTER_AREA when shrinking uses
  float weights and rounds to nearest, as cv2 does. cv2 may send a call to
  IPP, whose results are within one grey level of these for uint8 and
  within 1e-4 for float32.
- `rotate`, `affine` (cv2.warpAffine): the matrix inverted as cv2 inverts
  it, each output pixel's source position in float64, nearest (rounded half
  to even), bilinear or bicubic (A = -0.75) taps, INTER_AREA taken as
  bilinear; taps outside the image read the border: constant (cv2's
  Scalar: a number fills the first channel only, the others 0), replicate,
  reflect or reflect101. OpenCV 5.0's warpAffine computes the positions in
  floating point: its results agree with these within a few 1e-6 on float
  images and within one grey level on uint8. (OpenCV 4's warpAffine
  quantised them to 1/32 pixel, INTER_BITS 5, and used fixed-point weights
  for uint8; the JAX package's results follow the cv2 installed with it.)
- `to_grayscale` (cv2.cvtColor RGB2GRAY): uint8 by cv2's 15-bit integer
  weights (9798, 19235, 3735; bit-equal over all 2²⁴ colours), floats by
  0.299, 0.587, 0.114 in float32.
- `adjust_hue` (PIL's HSV): PIL's rgb2hsv and hsv2rgb row conversions, with
  their float32/float64 arithmetic, bit for bit; RGBA comes back with alpha
  255, as PIL's conversion gives it.
- `adjust_gamma` (cv2.LUT): a table lookup.

A one-channel (H, W, 1) image comes back from `resize` and `rotate` as
(H, W), as cv2 returns it.
"""

from __future__ import annotations

import math
import numbers
from typing import Sequence, Tuple

import numpy as np

from .degradation import resize_weights

INTERPOLATIONS = ("nearest", "bilinear", "bicubic", "area", "lanczos")
_BORDERS = ("constant", "replicate", "reflect", "reflect101")


def to_tensor(pic: np.ndarray) -> np.ndarray:
    """uint8/float HWC → float32 HWC in [0, 1] (the reference's to_tensor
    without the CHW permute)."""
    pic = np.asarray(pic)
    if pic.ndim == 2:
        pic = pic[:, :, None]
    if pic.dtype == np.uint8:
        return pic.astype(np.float32) / 255.0
    return pic.astype(np.float32)


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _size_pair(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


def _cv_out(out: np.ndarray, img: np.ndarray) -> np.ndarray:
    """cv2's return layout: a one-channel image as (H, W)."""
    return out[:, :, 0] if img.ndim == 3 and img.shape[2] == 1 else out


def _to_dtype(x: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(x), info.min, info.max).astype(dtype)
    return x.astype(dtype)


def _taps(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A (n_out, n_in) weight matrix as each output's source indices and
    weights, (n_out, K), padded with zero weights."""
    nz = m != 0
    k = max(int(nz.sum(axis=1).max()), 1)
    order = np.argsort(~nz, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(m, order, axis=1)


def _resize_to(img: np.ndarray, oh: int, ow: int, mode: str) -> np.ndarray:
    """cv2.resize(img, (ow, oh), interpolation=mode) for HWC or HW."""
    h, w = img.shape[:2]
    if (oh, ow) == (h, w):
        return img.copy()
    x = img if img.ndim == 3 else img[:, :, None]
    shrink = oh <= h and ow <= w
    wy = resize_weights(h, oh, mode, shrink)
    wx = resize_weights(w, ow, mode, shrink)
    fixed = img.dtype == np.uint8 and mode != "nearest" and not (mode == "area" and shrink)
    if fixed:  # cv2's fixed point: 11-bit weights, integer sums, one rounding at 2²²
        wy, wx = (np.rint(a * 2048) for a in (wy, wx))
    # columns, then rows, each output a sum over its few taps in float64
    # (exact on the fixed-point path, whose integer sums stay below 2⁵³)
    iy, ty = _taps(wy)
    ix, tx = _taps(wx)
    cols = np.einsum("hokc,ok->hoc", x.astype(np.float64)[:, ix], tx)
    acc = np.einsum("okpc,ok->opc", cols[iy], ty)
    if fixed:
        out = np.clip(np.floor((acc + (1 << 21)) / (1 << 22)), 0, 255).astype(np.uint8)
    else:
        out = _to_dtype(acc, img.dtype)
    return out if img.ndim == 3 else out[:, :, 0]


def resize(img: np.ndarray, size, interpolation: str = "bilinear") -> np.ndarray:
    """torchvision semantics: an int size sets the shorter side, keeping the
    aspect; (h, w) sets both."""
    if interpolation not in INTERPOLATIONS:
        raise KeyError(interpolation)
    h, w = img.shape[:2]
    if isinstance(size, numbers.Number):
        size = int(size)
        if (w <= h and w == size) or (h <= w and h == size):
            return img
        if w < h:
            return _cv_out(_resize_to(img, int(size * h / w), size, interpolation), img)
        return _cv_out(_resize_to(img, size, int(size * w / h), interpolation), img)
    th, tw = _size_pair(size)
    return _cv_out(_resize_to(img, th, tw, interpolation), img)


def crop(img: np.ndarray, i: int, j: int, h: int, w: int) -> np.ndarray:
    return img[i : i + h, j : j + w]


def center_crop(img: np.ndarray, output_size) -> np.ndarray:
    th, tw = _size_pair(output_size)
    h, w = img.shape[:2]
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return crop(img, i, j, th, tw)


def pad(img: np.ndarray, padding, fill=0, padding_mode: str = "constant"):
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    spec = [(pt, pb), (pl, pr)] + [(0, 0)] * (img.ndim - 2)
    if padding_mode == "constant":
        return np.pad(img, spec, constant_values=fill)
    return np.pad(img, spec, mode=padding_mode)


def hflip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


def vflip(img: np.ndarray) -> np.ndarray:
    return img[::-1]


# ------------------------------------------------------------- warpAffine

def _border_index(p: np.ndarray, n: int, border: str) -> np.ndarray:
    """cv2's borderInterpolate of integer positions; -1 for a constant
    border's outside."""
    if border == "constant":
        return np.where((p >= 0) & (p < n), p, -1)
    if border == "replicate" or n == 1:
        return np.clip(p, 0, n - 1)
    delta = 1 if border == "reflect101" else 0
    p = p.copy()
    while True:
        low, high = p < 0, p >= n
        if not (low.any() or high.any()):
            return p
        p = np.where(low, -p - 1 + delta, np.where(high, 2 * n - 1 - p - delta, p))


def _cubic_weights(t: np.ndarray) -> Tuple[np.ndarray, ...]:
    """cv2's interpolateCubic (A = -0.75) at fractions t."""
    a = -0.75
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    return c0, c1, c2, 1 - c0 - c1 - c2


def _warp_affine(img: np.ndarray, m: np.ndarray, size_wh: Tuple[int, int],
                 interpolation: str = "bilinear", border: str = "constant",
                 border_value=0) -> np.ndarray:
    """cv2.warpAffine(img, m, size_wh, flags=interpolation,
    borderMode=border, borderValue=border_value)."""
    if border not in _BORDERS:
        raise ValueError(f"border {border!r} not in {_BORDERS}")
    if interpolation == "area":  # cv2 warps INTER_AREA as INTER_LINEAR
        interpolation = "bilinear"
    m = np.asarray(m, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]

    x = img if img.ndim == 3 else img[:, :, None]
    h, w, c = x.shape
    ow, oh = int(size_wh[0]), int(size_wh[1])
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    sx = a11 * xs + a12 * ys + b1
    sy = a21 * xs + a22 * ys + b2
    if isinstance(border_value, numbers.Number):  # cv2's Scalar(v): v, 0, 0, 0
        fill = [float(border_value)] + [0.0] * (c - 1)
    else:
        fill = [float(v) for v in border_value][:c]
        fill += [0.0] * (c - len(fill))
    fill = np.asarray(fill)
    src = x.astype(np.float64)

    def tap(iy, ix):
        yy, xx = _border_index(iy, h, border), _border_index(ix, w, border)
        inside = (yy >= 0) & (xx >= 0)
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, fill)

    if interpolation == "nearest":
        out = tap(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    else:
        x0, y0 = np.floor(sx), np.floor(sy)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        if interpolation == "bilinear":
            wx, wy = (1 - fx, fx), (1 - fy, fy)
            offs = (0, 1)
        elif interpolation == "bicubic":
            wx, wy = _cubic_weights(fx), _cubic_weights(fy)
            offs = (-1, 0, 1, 2)
        else:
            raise ValueError(f"interpolation {interpolation!r}")
        out = sum(wy[i] * sum(wx[j] * tap(y0 + oy, x0 + ox) for j, ox in enumerate(offs))
                  for i, oy in enumerate(offs))
    return _to_dtype(out, img.dtype)


def _rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D (the centre as float32, cv2's Point2f)."""
    cx, cy = (float(np.float32(v)) for v in center)
    angle = angle * math.pi / 180
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def rotate(img: np.ndarray, angle: float, expand: bool = False) -> np.ndarray:
    h, w = img.shape[:2]
    center = (w / 2.0, h / 2.0)
    m = _rotation_matrix(center, angle, 1.0)
    if expand:
        cos, sin = abs(m[0, 0]), abs(m[0, 1])
        nw = int(h * sin + w * cos)
        nh = int(h * cos + w * sin)
        m[0, 2] += nw / 2.0 - center[0]
        m[1, 2] += nh / 2.0 - center[1]
        w, h = nw, nh
    return _cv_out(_warp_affine(img, m, (w, h)), img)


def resized_crop(img, i, j, h, w, size, interpolation="bilinear"):
    return resize(crop(img, i, j, h, w), size, interpolation)


def five_crop(img: np.ndarray, size):
    th, tw = _size_pair(size)
    h, w = img.shape[:2]
    if th > h or tw > w:
        raise ValueError("crop size larger than input")
    tl = crop(img, 0, 0, th, tw)
    tr = crop(img, 0, w - tw, th, tw)
    bl = crop(img, h - th, 0, th, tw)
    br = crop(img, h - th, w - tw, th, tw)
    cc = center_crop(img, (th, tw))
    return tl, tr, bl, br, cc


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    out = img.astype(np.float32) * factor
    hi = 255.0 if np.issubdtype(img.dtype, np.integer) else 1.0
    return np.clip(out, 0, hi).astype(img.dtype)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    gray = img.astype(np.float32)
    if img.ndim == 3 and img.shape[-1] == 3:
        gray = gray @ np.asarray([0.299, 0.587, 0.114], np.float32)
    mean = round(gray.mean())
    out = img.astype(np.float32) * factor + mean * (1 - factor)
    hi = 255.0 if np.issubdtype(img.dtype, np.integer) else 1.0
    return np.clip(out, 0, hi).astype(img.dtype)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img.astype(np.float32) @ np.asarray([0.299, 0.587, 0.114], np.float32))
    gray = np.round(gray)[..., None]
    out = img.astype(np.float32) * factor + gray * (1 - factor)
    hi = 255.0 if np.issubdtype(img.dtype, np.integer) else 1.0
    return np.clip(out, 0, hi).astype(img.dtype)


def ten_crop(img: np.ndarray, size, vertical_flip: bool = False):
    """five_crop of the image and of its flip."""
    first = five_crop(img, size)
    flipped = vflip(img) if vertical_flip else hflip(img)
    second = five_crop(flipped, size)
    return first + second


# ------------------------------------------------------------ PIL's HSV

def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """PIL's rgb2hsv_row on uint8 (..., 3): h and s truncated from float
    fractions of 255, v the maximum."""
    f32 = np.float32
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    same = maxc == minc
    cr = (maxc - minc).astype(f32)
    cr_safe = np.where(same, f32(1), cr)
    s = cr / np.where(maxc == 0, f32(1), maxc.astype(f32))
    rc, gc, bc = (((maxc - v).astype(f32)) / cr_safe for v in (r, g, b))
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, (2.0 + rc.astype(np.float64) - bc).astype(f32),
                          (4.0 + gc.astype(np.float64) - rc).astype(f32)))
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(f32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    out = np.stack([np.where(same, 0, uh), np.where(same, 0, us), maxc], axis=-1)
    return out.astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """PIL's hsv2rgb on uint8 (..., 3)."""
    f32 = np.float32
    h, s, v = (hsv[..., i].astype(np.int64) for i in range(3))
    hf = h.astype(f32).astype(np.float64) * 6.0 / 255.0
    i = np.floor(hf).astype(np.int64)
    f = (hf - i.astype(f32)).astype(f32)
    fs = (s.astype(f32).astype(np.float64) / 255.0).astype(f32)
    vd = v.astype(f32).astype(np.float64)

    def rnd(x):  # C round(): half away from zero
        return np.clip(np.sign(x) * np.floor(np.abs(x) + 0.5), 0, 255).astype(np.int64)

    p = rnd(vd * (1.0 - fs.astype(np.float64)))
    q = rnd(vd * (1.0 - (fs * f).astype(np.float64)))
    t = rnd(vd * (1.0 - fs.astype(np.float64) * (1.0 - f.astype(np.float64))))
    sector = i % 6
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = [np.select([sector == k for k in range(6)], [row[ch] for row in table])
           for ch in range(3)]
    gray = s == 0
    return np.stack([np.where(gray, v, o) for o in out], axis=-1).astype(np.uint8)


def adjust_hue(img: np.ndarray, hue_factor: float) -> np.ndarray:
    """Cyclic shift of the HSV hue channel (PIL-HSV semantics: hue in
    [0, 255] with uint8 wraparound)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor is not in [-0.5, 0.5].")
    if img.ndim == 2 or img.shape[-1] == 1:
        return img
    img = np.ascontiguousarray(img)
    hsv = rgb_to_hsv(img[..., :3])
    h = (hsv[..., 0].astype(np.int16) + int(hue_factor * 255)) % 256
    rgb = hsv_to_rgb(np.stack([h.astype(np.uint8), hsv[..., 1], hsv[..., 2]], axis=-1))
    if img.shape[-1] == 4:  # PIL's HSV → RGBA conversion gives alpha 255
        return np.concatenate([rgb, np.full(rgb.shape[:-1] + (1,), 255, np.uint8)], axis=-1)
    return rgb


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1) -> np.ndarray:
    """Power-law transform through a uint8 lookup table (cv2.LUT)."""
    if gamma < 0:
        raise ValueError("Gamma should be a non-negative real number")
    table = np.array(
        [((i / 255.0) ** gamma) * 255 * gain for i in np.arange(0, 256)]
    ).astype("uint8")
    if img.ndim == 3 and img.shape[2] == 1:
        return table[img[:, :, 0]][:, :, np.newaxis]
    return table[img]


def _get_affine_matrix(center, angle, translate, scale, shear):
    """M = T·C·RSS·C⁻¹."""
    angle = math.radians(angle)
    shear = math.radians(shear)
    T = np.array([[1, 0, translate[0]], [0, 1, translate[1]], [0, 0, 1]])
    C = np.array([[1, 0, center[0]], [0, 1, center[1]], [0, 0, 1]])
    RSS = np.array(
        [
            [math.cos(angle) * scale, -math.sin(angle + shear) * scale, 0],
            [math.sin(angle) * scale, math.cos(angle + shear) * scale, 0],
            [0, 0, 1],
        ]
    )
    return (T @ C @ RSS @ np.linalg.inv(C))[:2, :]


def affine(
    img: np.ndarray,
    angle: float,
    translate,
    scale: float,
    shear: float,
    interpolation: str = "bilinear",
    mode: str = "constant",
    fillcolor=0,
) -> np.ndarray:
    """Centre-invariant affine warp."""
    if scale <= 0.0:
        raise ValueError("Argument scale should be positive")
    if interpolation not in ("nearest", "bilinear", "bicubic", "area"):
        raise KeyError(interpolation)
    if mode not in _BORDERS:
        raise KeyError(mode)
    h, w = img.shape[:2]
    center = (w * 0.5 + 0.5, h * 0.5 + 0.5)
    matrix = _get_affine_matrix(center, angle, translate, scale, shear)
    out = _warp_affine(img, matrix, (w, h), interpolation, mode, fillcolor)
    if img.ndim == 3 and img.shape[2] == 1:
        return out
    return out if img.ndim == 3 else out[:, :, 0]


def to_grayscale(img: np.ndarray, num_output_channels: int = 1) -> np.ndarray:
    """RGB → grayscale, 1 or 3 output channels."""
    if img.dtype == np.uint8:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        gray = ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)
    else:
        f = img.astype(np.float32)
        gray = (f[..., 0] * np.float32(0.299) + f[..., 1] * np.float32(0.587)
                + f[..., 2] * np.float32(0.114)).astype(img.dtype)
    gray = gray[:, :, np.newaxis]
    if num_output_channels == 3:
        return np.broadcast_to(gray, img.shape)
    if num_output_channels != 1:
        raise ValueError("num_output_channels should be either 1 or 3")
    return gray


# ---------------------------------------------------------------------------
# class API (the reference's opencv_transforms/transforms.py): composable
# transform objects over the functional surface above
# ---------------------------------------------------------------------------


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class Lambda:
    def __init__(self, lambd):
        self.lambd = lambd

    def __call__(self, img):
        return self.lambd(img)


class ToTensor:
    def __call__(self, pic):
        return to_tensor(pic)


class Normalize:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, img):
        return normalize(img, self.mean, self.std)


class Resize:
    def __init__(self, size, interpolation: str = "bilinear"):
        self.size, self.interpolation = size, interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return center_crop(img, self.size)


class Pad:
    def __init__(self, padding, fill=0, padding_mode: str = "constant"):
        self.padding, self.fill, self.padding_mode = padding, fill, padding_mode

    def __call__(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class RandomCrop:
    def __init__(self, size, padding=0, rng: "np.random.Generator" = None):
        self.size = _size_pair(size)
        self.padding = padding
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        if self.padding:
            img = pad(img, self.padding)
        h, w = img.shape[:2]
        th, tw = self.size
        i = int(self.rng.integers(0, h - th + 1))
        j = int(self.rng.integers(0, w - tw + 1))
        return crop(img, i, j, th, tw)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        return hflip(img) if self.rng.random() < self.p else img


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        return vflip(img) if self.rng.random() < self.p else img


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation: str = "bilinear", rng=None):
        self.size = _size_pair(size)
        self.scale, self.ratio = scale, ratio
        self.interpolation = interpolation
        self.rng = rng or np.random.default_rng()

    def get_params(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * self.rng.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            ar = math.exp(self.rng.uniform(*log_ratio))
            tw = int(round(math.sqrt(target * ar)))
            th = int(round(math.sqrt(target / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = int(self.rng.integers(0, h - th + 1))
                j = int(self.rng.integers(0, w - tw + 1))
                return i, j, th, tw
        # fallback: centre crop
        th = tw = min(h, w)
        return (h - th) // 2, (w - tw) // 2, th, tw

    def __call__(self, img):
        i, j, th, tw = self.get_params(img)
        return resized_crop(img, i, j, th, tw, self.size, self.interpolation)


class FiveCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return five_crop(img, self.size)


class TenCrop:
    def __init__(self, size, vertical_flip: bool = False):
        self.size, self.vertical_flip = size, vertical_flip

    def __call__(self, img):
        return ten_crop(img, self.size, self.vertical_flip)


class Grayscale:
    def __init__(self, num_output_channels: int = 1):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation:
    def __init__(self, degrees, rng=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        angle = self.rng.uniform(*self.degrees)
        return rotate(img, angle)


class RandomAffine:
    def __init__(self, degrees, translate=None, scale=None, shear=None, rng=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees, self.translate = degrees, translate
        self.scale_range, self.shear = scale, shear
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        angle = self.rng.uniform(*self.degrees)
        h, w = img.shape[:2]
        if self.translate is not None:
            tx = self.rng.uniform(-self.translate[0], self.translate[0]) * w
            ty = self.rng.uniform(-self.translate[1], self.translate[1]) * h
            translate = (int(round(tx)), int(round(ty)))
        else:
            translate = (0, 0)
        scale = self.rng.uniform(*self.scale_range) if self.scale_range else 1.0
        if self.shear is not None:
            shear_range = (
                (-self.shear, self.shear)
                if isinstance(self.shear, numbers.Number) else self.shear
            )
            shear = self.rng.uniform(*shear_range)
        else:
            shear = 0.0
        return affine(img, angle, translate, scale, shear)


class ColorJitter:
    """Brightness, contrast, saturation and hue jitter, in a random order,
    each with its own drawn factor (the reference's Lambdas; the JAX class's
    closures all read the last factor drawn, hi3d_tpu/data/transforms.py:
    467-483, which this class does not mirror). The draws are JAX's, in
    its order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, rng=None):
        self.brightness, self.contrast = brightness, contrast
        self.saturation, self.hue = saturation, hue
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        ops = []
        if self.brightness > 0:
            f = self.rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im, f=f: adjust_brightness(im, f))
        if self.contrast > 0:
            f = self.rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im, f=f: adjust_contrast(im, f))
        if self.saturation > 0:
            f = self.rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im, f=f: adjust_saturation(im, f))
        if self.hue > 0:
            f = self.rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, f=f: adjust_hue(im, f))
        self.rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img
