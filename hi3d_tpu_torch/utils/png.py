"""PNG reader and writer on the standard library (zlib + struct), numpy and a
small C unfilter built at first use (`csrc/png_unfilter.c`).

The GPU host has no cv2/PIL/imageio guarantee, so the port reads its input
image and writes its frames with this module. Reader scope, as cv2's
`IMREAD_UNCHANGED` decodes it (libpng): non-interlaced and Adam7-interlaced
images, all five scanline filter types; grey at 1, 2, 4 and 8 bits (scaled
to 8 bits; a tRNS chunk ignored), 8-bit gray+alpha, RGB (RGBA when a tRNS
chunk names a key colour: alpha 0 on exactly its pixels) and RGBA, and
palette images at 1, 2, 4 and 8 bits, expanded to RGB (RGBA when a tRNS
chunk is present). 16-bit images raise. `decode_png` reads one held in
memory (a tar member).
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
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))

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


def _expand_palette(idx: np.ndarray, plte: bytes, trns: bytes) -> np.ndarray:
    """Palette indices (H, W) → (H, W, 3) RGB, or (H, W, 4) RGBA when the
    image has a tRNS chunk (entries past its end are opaque). Indices past
    the end of PLTE read as black."""
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    n = min(len(plte) // 3, 256)
    table[:n, :3] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
    if trns:
        table[:len(trns), 3] = np.frombuffer(trns[:256], np.uint8)
        return table[idx]
    return table[idx, :3]


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered rows (H, stride) → samples (H, W, ch) uint8 as stored: a
    depth below 8 (one channel) is unpacked MSB first, each row padded to
    whole bytes."""
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :w, None]
    return rows[:, :w * ch].reshape(rows.shape[0], w, ch)


def _passes(w: int, h: int, interlace: int):
    """(x0, y0, dx, dy, width, height) of each non-empty pass: the whole
    image, or Adam7's seven sub-images (a pass of no pixels stores no
    bytes, not even filter types)."""
    grid = ((0, 0, 1, 1),) if interlace == 0 else _ADAM7
    for x0, y0, dx, dy in grid:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            yield x0, y0, dx, dy, pw, ph


def read_png(path: str) -> np.ndarray:
    """uint8 (H, W, C): C = 1, 2, 3 or 4 samples as stored (grey below 8
    bits scaled to 8), a palette expanded to 3 (RGB) or, with a tRNS chunk,
    4 (RGBA), and RGB with a tRNS key as RGBA."""
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
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        if pos + 12 + length > len(blob):
            raise ValueError(f"{name}: a truncated PNG: its {kind!r} chunk runs past the end")
        body = blob[pos + 8:pos + 8 + length]
        crc = blob[pos + 8 + length:pos + 12 + length]
        pos += 12 + length
        critical = not kind[0] & 0x20  # the case bit of its first letter
        if int.from_bytes(crc, "big") != zlib.crc32(kind + body):
            if critical:  # libpng: an error; an ancillary chunk is dropped
                raise ValueError(f"{name}: a PNG {kind!r} chunk with a bad CRC")
            continue
        if critical and kind not in (b"IHDR", b"PLTE", b"IDAT", b"IEND"):
            raise ValueError(f"{name}: an unknown critical PNG chunk {kind!r}")
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"{name}: a PNG header of {length} bytes (13 expected)")
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
    if kind != b"IEND":
        raise ValueError(f"{name}: a truncated PNG: no IEND chunk")
    w, h, depth, ctype, _, _, interlace = header
    palette = ctype == _PALETTE and depth in (1, 2, 4, 8) and plte
    grey = ctype == 0 and depth in (1, 2, 4, 8)
    if not (palette or grey or (depth == 8 and ctype in _CHANNELS)) or interlace > 1:
        raise ValueError(
            f"{name}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); need 8-bit gray+alpha/RGB(A), 1/2/4/8-bit gray or "
            "palette, interlaced or not (16-bit PNGs do not decode)"
        )
    if w == 0 or h == 0:
        raise ValueError(f"{name}: a PNG of {w}×{h} pixels")
    ch = 1 if palette else _CHANNELS[ctype]
    passes = list(_passes(w, h, interlace))
    strides = [(pw * depth * ch + 7) // 8 for *_, pw, _ in passes]
    need = sum(ph * (s + 1) for (*_, ph), s in zip(passes, strides))
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    if len(raw) != need:
        raise ValueError(f"{name}: PNG data size {len(raw)} != the {need} bytes of a "
                         f"{w}×{h} image")
    samples = np.empty((h, w, ch), np.uint8)
    start = 0
    for (x0, y0, dx, dy, pw, ph), stride in zip(passes, strides):
        size = ph * (stride + 1)
        rows = _unfilter(raw[start:start + size], ph, stride, max(1, depth * ch // 8))
        samples[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
        start += size
    if palette:
        return _expand_palette(samples[..., 0], plte, trns)
    if grey and depth < 8:  # libpng's expand_gray_1_2_4_to_8; tRNS ignored, as cv2
        return samples * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 2 and len(trns) >= 6:  # png_set_tRNS_to_alpha: the key's pixels clear
        key = np.frombuffer(trns[:6], ">u2").astype(np.uint8)  # libpng's low bytes
        alpha = np.where((samples == key).all(axis=-1), 0, 255).astype(np.uint8)
        return np.concatenate([samples, alpha[..., None]], axis=-1)
    return samples


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
