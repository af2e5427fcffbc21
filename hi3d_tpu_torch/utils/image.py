"""Host-side image preprocessing for the CLIs (counterpart of
hi3d_tpu/utils/image.py), on numpy and the stdlib PNG codec only.

`resize_bilinear_u8` follows cv2.resize's INTER_LINEAR sampling (half-pixel
centres, edge clamp) in floating point; cv2 itself rounds through 11-bit
fixed-point weights, so the two agree to within one grey level, and exactly
when the size does not change.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .png import read_png


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


def _read_cv2(path: str) -> np.ndarray:
    """uint8 HWC in RGB(A) channel order, through cv2 (formats other than PNG)."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"cannot read {path!r}: only PNG decodes without cv2, which does not "
                           "import here; convert the image to PNG") from None
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:  # gray
        return img[..., None]
    return img[..., [2, 1, 0, 3][:img.shape[-1]]]  # BGR(A) → RGB(A)


def load_image_rgb(path: str) -> np.ndarray:
    """uint8 HWC RGB; RGBA is composited onto white, gray is replicated. PNG
    goes through the stdlib codec; other formats need cv2."""
    img = read_png(path) if path.lower().endswith(".png") else _read_cv2(path)
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
