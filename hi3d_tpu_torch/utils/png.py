"""PNG reader and writer on the standard library (zlib + struct), numpy and a
small C unfilter built at first use (`csrc/png_unfilter.c`).

The GPU host has no cv2/PIL/imageio guarantee, so the port reads its input
image and writes its frames with this module. Reader scope: non-interlaced,
all five scanline filter types; 8-bit grayscale, gray+alpha, RGB and RGBA,
and palette images at 1, 2, 4 and 8 bits, expanded to RGB (RGBA when a tRNS
chunk is present), as cv2's `IMREAD_UNCHANGED` decodes them. `decode_png`
reads one held in memory (a tar member).
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from . import cbuild
from .jpeg import is_jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type → samples per pixel
_PALETTE = 3  # colour type of indexed-colour images

_BUILD_DIR = cbuild.BUILD_DIR
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _native() -> ctypes.CDLL:
    """The C unfilter (`csrc/png_unfilter.c`), built at first use by
    `utils.cbuild` into `_BUILD_DIR` (one build per source hash; one thread
    builds while the others wait)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = cbuild.load("png_unfilter.c", "hi3d_png", "read_png", _BUILD_DIR)
        lib.hi3d_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_long, ctypes.c_int]
        lib.hi3d_png_unfilter.restype = ctypes.c_int
        _lib = lib
    return _lib


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters of `h` rows of `stride` bytes; `bpp` is the
    filters' byte distance (bytes per pixel, at least 1)."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data size {data.size} != {h}×({stride}+1)")
    out = np.empty((h, stride), np.uint8)
    bad = _native().hi3d_png_unfilter(data.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad:
        y = bad - 1
        raise ValueError(f"unknown PNG filter type {data[y * (stride + 1)]} in row {y}")
    return out


def _unfilter_reference(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Plain version of `_unfilter`, one Python step a byte on Average and
    Paeth rows."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data size {data.size} != {h}×({stride}+1)")
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: a running sum along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur_l = line.tolist()
            up = prev.tolist()
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[x] = (cur_l[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def _expand_palette(rows: np.ndarray, w: int, depth: int, plte: bytes,
                    trns: bytes) -> np.ndarray:
    """Unfiltered index rows (H, stride) at `depth` bits → (H, W, 3) RGB, or
    (H, W, 4) RGBA when the image has a tRNS chunk (entries past its end are
    opaque). Indices past the end of PLTE read as black."""
    if depth < 8:  # MSB-first sub-byte indices, each row padded to whole bytes
        bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        idx = (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :w]
    else:
        idx = rows[:, :w]
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    n = min(len(plte) // 3, 256)
    table[:n, :3] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
    if trns:
        table[:len(trns), 3] = np.frombuffer(trns[:256], np.uint8)
        return table[idx]
    return table[idx, :3]


def read_png(path: str) -> np.ndarray:
    """uint8 (H, W, C): C = 1, 2, 3 or 4 samples as stored, or a palette
    expanded to 3 (RGB) or, with a tRNS chunk, 4 (RGBA)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """`read_png` on an encoded PNG held in memory (a tar member, say);
    `name` labels the errors. A JPEG raises: `utils.jpeg.decode_jpeg` reads
    it (`utils.image.decode_image` reads either)."""
    if is_jpeg(blob):
        raise ValueError(f"{name}: a JPEG, not a PNG; decode it with utils.jpeg.decode_jpeg")
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos = len(_SIGNATURE)
    idat = []
    header = None
    plte = trns = b""
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    palette = ctype == _PALETTE and depth in (1, 2, 4, 8) and plte
    if not (palette or (depth == 8 and ctype in _CHANNELS)) or interlace != 0:
        raise ValueError(
            f"{name}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); need non-interlaced 8-bit gray/RGB(A) or a "
            "1/2/4/8-bit palette"
        )
    raw = zlib.decompress(b"".join(idat))
    if palette:
        rows = _unfilter(raw, h, (w * depth + 7) // 8, 1)
        return _expand_palette(rows, w, depth, plte, trns)
    ch = _CHANNELS[ctype]
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def png_colour_type(blob: bytes, name: str = "<bytes>") -> int:
    """The colour type in an encoded PNG's IHDR (0 gray, 2 RGB, 3 palette,
    4 gray + alpha, 6 RGBA)."""
    if not blob.startswith(_SIGNATURE) or blob[12:16] != b"IHDR":
        raise ValueError(f"{name}: not a PNG file")
    return blob[25]


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 (H, W) or (H, W, 1|2|3|4) as a filter-0 PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1
    )
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
