"""GIF decoder without cv2 or PIL, as `cv2.imdecode(...,
cv2.IMREAD_UNCHANGED)` reads the format (OpenCV 5.0's own GifDecoder,
grfmt_gif.cpp), bit for bit, as RGB(A): the first image of the file.

- The whole file is walked first, to its trailer: a block cv2 does not
  know, a missing trailer or data that end early raise a ValueError, as do
  what cv2 5.0 fails on among valid files: a disposal method past 3, an
  application extension other than NETSCAPE2.0 with a 3-byte sub-block.
- The first image is drawn on a canvas of the logical screen's size,
  filled with the global colour table's background colour (black without
  a global table), alpha 0; the image may not reach past the screen.
  Its pixels take the local colour table, else the global one (an index
  past the table raises); interlaced rows are put back in order; a pixel
  equal to the transparent index of the graphic control extension before
  the image keeps the canvas's colour and alpha, the others get alpha 255.
- (H, W, 4) RGBA when any graphic control extension of the file sets the
  transparency flag (cv2's rule; PIL drops the flag when no pixel uses the
  index), else (H, W, 3) RGB.
The LZW codes decode in C (`csrc/raster_decode.c`), a full table kept
until a clear code as cv2 keeps it.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from .raster import check_size, gif_lzw


def is_gif(blob: bytes) -> bool:
    return blob[:6] in (b"GIF87a", b"GIF89a")


def _sub_blocks(blob: bytes, pos: int, name: str) -> Tuple[List[bytes], int]:
    """The data sub-blocks from `pos` to their terminator, and the position
    after it."""
    out = []
    while True:
        if pos >= len(blob):
            raise ValueError(f"{name}: a truncated GIF: its data sub-blocks run past the end")
        n = blob[pos]
        if n == 0:
            return out, pos + 1
        if pos + 1 + n > len(blob):
            raise ValueError(f"{name}: a truncated GIF: a data sub-block runs past the end")
        out.append(blob[pos + 1:pos + 1 + n])
        pos += 1 + n


def _table(blob: bytes, pos: int, flags: int, name: str) -> Tuple[np.ndarray, int]:
    n = 2 << (flags & 7)
    if pos + 3 * n > len(blob):
        raise ValueError(f"{name}: a truncated GIF colour table")
    return np.frombuffer(blob, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def decode_gif(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 (H, W, 3) RGB or (H, W, 4) RGBA of the first image; `name`
    labels the errors."""
    if not is_gif(blob):
        raise ValueError(f"{name}: not a GIF file")
    if len(blob) < 13:
        raise ValueError(f"{name}: a truncated GIF header")
    width, height, flags, bg = struct.unpack_from("<HHBB", blob, 6)
    check_size(width, height, name, "a GIF screen")
    pos, gct = 13, None
    if flags & 0x80:
        gct, pos = _table(blob, pos, flags, name)
        if bg >= len(gct):
            raise ValueError(f"{name}: a GIF background index {bg} past its {len(gct)} colours")
    transparent, first, any_transparency = None, None, False
    while True:
        if pos >= len(blob):
            raise ValueError(f"{name}: a truncated GIF: no trailer")
        kind = blob[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos + 2 > len(blob):
                raise ValueError(f"{name}: a truncated GIF extension")
            label = blob[pos + 1]
            blocks, pos = _sub_blocks(blob, pos + 2, name)
            if label == 0xFF and blocks[:1] != [b"NETSCAPE2.0"] and \
                    any(len(b) == 3 for b in blocks):
                raise ValueError(f"{name}: a GIF application extension with a 3-byte block "
                                 "outside NETSCAPE2.0, which cv2 fails on")
            if label == 0xF9:
                if len(blocks) != 1 or len(blocks[0]) != 4 or (blocks[0][0] >> 2) & 7 > 3:
                    raise ValueError(f"{name}: a malformed GIF graphic control extension")
                if blocks[0][0] & 1:
                    any_transparency = True
                    transparent = blocks[0][3]
                else:
                    transparent = None
        elif kind == 0x2C:
            if pos + 10 > len(blob):
                raise ValueError(f"{name}: a truncated GIF image descriptor")
            left, top, w, h, iflags = struct.unpack_from("<HHHHB", blob, pos + 1)
            pos += 10
            table = gct
            if iflags & 0x80:
                table, pos = _table(blob, pos, iflags, name)
            if pos >= len(blob):
                raise ValueError(f"{name}: a truncated GIF image")
            mcs = blob[pos]
            blocks, pos = _sub_blocks(blob, pos + 1, name)
            if first is None:
                first = (left, top, w, h, iflags, table, mcs, b"".join(blocks), transparent)
            transparent = None
        else:
            raise ValueError(f"{name}: a GIF block of kind 0x{kind:02x}")
    if first is None:
        raise ValueError(f"{name}: a GIF without an image")
    left, top, w, h, iflags, table, mcs, data, transparent = first
    if not (w > 0 and h > 0 and left + w <= width and top + h <= height):
        raise ValueError(f"{name}: a GIF image of {w}×{h} at ({left}, {top}) on a "
                         f"{width}×{height} screen")
    if table is None:
        raise ValueError(f"{name}: a GIF image without a colour table")
    if not 2 <= mcs <= 11:
        raise ValueError(f"{name}: a GIF LZW minimum code size of {mcs}")
    idx = gif_lzw(data, mcs, w * h, name).reshape(h, w)
    if iflags & 0x40:  # interlaced: the rows of passes 1-4 in the stream's order
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    if int(idx.max()) >= len(table):
        raise ValueError(f"{name}: a GIF colour index {int(idx.max())} past its "
                         f"{len(table)} colours")
    canvas = np.zeros((height, width, 4), np.uint8)
    if gct is not None:
        canvas[..., :3] = gct[bg]
    frame = np.concatenate([table[idx], np.full((h, w, 1), 255, np.uint8)], axis=-1)
    region = canvas[top:top + h, left:left + w]
    if transparent is not None:
        frame = np.where((idx == transparent)[..., None], region, frame)
    canvas[top:top + h, left:left + w] = frame
    return canvas if any_transparency else np.ascontiguousarray(canvas[..., :3])


def read_gif(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gif(f.read(), path)

