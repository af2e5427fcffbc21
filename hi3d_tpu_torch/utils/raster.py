"""What the port's BMP, TIFF, GIF, PNM and Sun raster readers share: the
ctypes binding of `csrc/raster_decode.c` (built at first use by
`utils.cbuild`), the `Unsupported` error, and OpenCV's palette and grey
conversions, which cv2's decoders of those formats apply (its
`icvCvt_BGR2Gray_8u_C3C1R`: 14-bit fixed-point weights, rounded)."""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import cbuild


class Unsupported(ValueError):
    """A format or a variant of one that the port does not decode; the
    message names it. `utils.image` hands such a file to cv2 where cv2
    imports."""


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_ERRORS = {-1: "the data end before the image does", -2: "a code its table does not hold",
           -3: "a run past the end of its row", -4: "more pixels than the image holds",
           -5: "bad arguments", -7: "an escape cv2 fails on (end of bitmap before the last "
           "row, or a delta that moves down)"}


def _native() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cbuild.load("raster_decode.c", "hi3d_raster", "utils.raster")
            p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            for fn, args, res in (("hi3d_gif_lzw", [p, l, i, p, l], l),
                                  ("hi3d_tiff_lzw", [p, l, p, l], l),
                                  ("hi3d_packbits", [p, l, p, l], l),
                                  ("hi3d_tiff_predict8", [p, l, l, i], None),
                                  ("hi3d_bmp_rle", [p, l, i, i, i, p], i)):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _lib = lib
    return _lib


# cv2's CV_IO_MAX_IMAGE_WIDTH, _HEIGHT and _PIXELS: it decodes nothing larger
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def check_size(w: int, h: int, name: str, what: str = "an image") -> None:
    """Raise for sizes cv2 refuses (none, or past its limits)."""
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE and w * h <= MAX_PIXELS):
        raise ValueError(f"{name}: {what} of {w}×{h} pixels, outside cv2's limits")


def _fail(err: int, what: str, name: str):
    raise ValueError(f"{name}: corrupt {what}: {_ERRORS.get(err, err)}")


def gif_lzw(data: bytes, min_code_size: int, npix: int, name: str) -> np.ndarray:
    """A GIF image's joined data sub-blocks → its npix colour indices."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(npix, np.uint8)
    n = _native().hi3d_gif_lzw(src.ctypes.data, src.size, min_code_size, out.ctypes.data, npix)
    if n < 0:
        _fail(n, "GIF LZW data", name)
    if n != npix:
        raise ValueError(f"{name}: corrupt GIF LZW data: {n} of {npix} pixels")
    return out


def tiff_lzw(data: bytes, occ: int, name: str) -> np.ndarray:
    """A TIFF strip or tile in LZW (either form) → its occ bytes."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(occ, np.uint8)
    n = _native().hi3d_tiff_lzw(src.ctypes.data, src.size, out.ctypes.data, occ)
    if n < 0:
        _fail(n, "TIFF LZW data", name)
    if n < occ:
        raise ValueError(f"{name}: corrupt TIFF LZW data: {n} of {occ} bytes")
    return out


def packbits(data: bytes, occ: int, name: str) -> np.ndarray:
    """A TIFF strip or tile in PackBits → its occ bytes."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(occ, np.uint8)
    n = _native().hi3d_packbits(src.ctypes.data, src.size, out.ctypes.data, occ)
    if n < occ:
        raise ValueError(f"{name}: corrupt TIFF PackBits data: {n} of {occ} bytes")
    return out


def predict8(buf: np.ndarray, stride: int) -> None:
    """Undo TIFF's horizontal predictor in place on (rows, row_bytes) uint8."""
    assert buf.dtype == np.uint8 and buf.ndim == 2 and buf.flags.c_contiguous
    _native().hi3d_tiff_predict8(buf.ctypes.data, buf.shape[0], buf.shape[1], stride)


def bmp_rle(data: bytes, w: int, h: int, bits: int, name: str) -> np.ndarray:
    """BI_RLE8/BI_RLE4 pixel data → (h, w) palette indices, rows in the
    file's order."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((h, w), np.uint8)
    err = _native().hi3d_bmp_rle(src.ctypes.data, src.size, w, h, bits, out.ctypes.data)
    if err:
        _fail(err, f"BMP RLE{bits} data", name)
    return out


def bgr_to_grey(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray_8u_C3C1R on (..., 3+) uint8 BGR(A):
    (B·1868 + G·9617 + R·4899 + 2¹³) >> 14."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)


def unpack_indices(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """(h, row_bytes) uint8 of `bits`-bit samples, MSB first → (h, width)."""
    if bits == 8:
        return rows[:, :width]
    if bits == 1:
        return np.unpackbits(rows, axis=1)[:, :width]
    per = 8 // bits
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    out = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return out.reshape(rows.shape[0], rows.shape[1] * per)[:, :width]


def is_colour_palette(bgr: np.ndarray) -> bool:
    """OpenCV's IsColorPalette: some entry whose B, G and R differ."""
    return bool(((bgr[:, 0] != bgr[:, 1]) | (bgr[:, 0] != bgr[:, 2])).any())


def with_palette(idx: np.ndarray, bgr: np.ndarray, colour: bool) -> np.ndarray:
    """Indices through a BGR palette as cv2 fills rows: RGB (h, w, 3) when
    `colour`, else (h, w, 1) grey from the palette's grey levels."""
    if colour:
        return np.ascontiguousarray(bgr[idx][..., ::-1])
    return bgr_to_grey(bgr)[idx][..., None]
