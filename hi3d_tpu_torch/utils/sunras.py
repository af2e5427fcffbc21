"""Sun raster decoder without cv2 or PIL, as `cv2.imdecode(...,
cv2.IMREAD_UNCHANGED)` reads the format (OpenCV 5.0's SunRasterDecoder,
grfmt_sunras.cpp), bit for bit, as RGB:
- the big-endian header (magic 0x59a66a95, width, height, depth, length,
  type, map type, map length); types 0 (old) and 1 (standard); rows padded
  to 16 bits;
- 1 and 8 bits through an equal-RGB colormap (map type 1, at most 2^depth
  entries; missing entries are black): (H, W, 3) when some entry is not
  grey, else (H, W, 1) of the entries' grey levels. Without a colormap cv2
  5.0 returns every pixel 0, and so does this decoder (its own grey
  `.ras` files read back black in cv2, and in the JAX package through it);
- 24 bits as B, G, R bytes and 32 bits as X, B, G, R, both (H, W, 3).
cv2 5.0 decodes no byte-encoded (type 2) and no RGB-format (type 3) file
(its readData fails on every one), so this decoder refuses them too, by
name (`Unsupported`); other types, map types and depths raise
`Unsupported` as well, and data that end early a ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from .raster import Unsupported, check_size, is_colour_palette, unpack_indices, with_palette

MAGIC = b"\x59\xa6\x6a\x95"


def is_sunras(blob: bytes) -> bool:
    return blob[:4] == MAGIC


def decode_sunras(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 (H, W, 1) or (H, W, 3) RGB; `name` labels the errors."""
    if not is_sunras(blob):
        raise ValueError(f"{name}: not a Sun raster file")
    if len(blob) < 32:
        raise ValueError(f"{name}: a truncated Sun raster header")
    w, h, depth, _, kind, maptype, maplength = struct.unpack_from(">7i", blob, 4)
    check_size(w, h, name, "a Sun raster")
    if depth not in (1, 8, 24, 32):
        raise Unsupported(f"{name}: a Sun raster of depth {depth}; cv2 reads 1, 8, 24 and 32")
    if kind in (2, 3):
        raise Unsupported(f"{name}: a {('byte-encoded', 'RGB-format')[kind - 2]} Sun raster "
                          f"(type {kind}), which cv2 5.0 does not decode either")
    if kind not in (0, 1):
        raise Unsupported(f"{name}: a Sun raster of type {kind}")
    palette = None
    if maptype == 0 and maplength == 0:
        if depth <= 8:
            palette, colour = np.zeros((256, 3), np.uint8), False
    elif maptype == 1 and 0 < maplength <= 3 << depth and depth <= 8:
        if 32 + maplength > len(blob):
            raise ValueError(f"{name}: a truncated Sun raster colormap")
        n = maplength // 3
        cmap = np.frombuffer(blob, np.uint8, 3 * n, 32).reshape(3, n)
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = cmap[::-1].T  # B, G, R
        colour = is_colour_palette(palette[:1 << depth])
    else:
        raise Unsupported(f"{name}: a Sun raster with map type {maptype} and map length "
                          f"{maplength} at depth {depth}")
    offset = 32 + maplength
    pitch = ((w * depth + 7) // 8 + 1) & -2
    if offset + pitch * h > len(blob):
        raise ValueError(f"{name}: a truncated Sun raster")
    rows = np.frombuffer(blob, np.uint8, pitch * h, offset).reshape(h, pitch)
    if depth <= 8:
        return with_palette(unpack_indices(rows, depth, w), palette, colour)
    nb = depth // 8
    px = rows[:, :w * nb].reshape(h, w, nb)
    return np.ascontiguousarray(px[..., :0:-1] if nb == 4 else px[..., ::-1])


def read_sunras(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_sunras(f.read(), path)
