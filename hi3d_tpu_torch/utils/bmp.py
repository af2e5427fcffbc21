"""BMP decoder without cv2 or PIL (counterpart of the JAX package's reads
through cv2: hi3d_tpu/utils/image.py `load_image_rgb` and
hi3d_tpu/data/video_dataset.py:37-66).

`decode_bmp` gives what `cv2.imdecode(..., cv2.IMREAD_UNCHANGED)` gives
(OpenCV's own BmpDecoder, grfmt_bmp.cpp), bit for bit, as RGB(A):
- headers: BITMAPCOREHEADER (OS/2, 12 bytes), INFO (40) and the longer
  V2-V5 headers; bottom-up and top-down rows; pixel data from the file
  header's offset;
- 1, 4 and 8 bits a pixel through the palette (clrUsed entries, else
  2^bits; missing entries are black): (H, W, 3) when some entry is not
  grey, else (H, W, 1) of the entries' grey levels; BI_RLE8 and BI_RLE4
  as cv2 runs them (`csrc/raster_decode.c`);
- 16 bits: BI_RGB and BI_BITFIELDS with the 5-5-5 masks, BI_BITFIELDS with
  5-6-5, expanded by shifts as cv2 does (no bit replication); the masks
  are read right after the header, where cv2 reads them;
- 24 bits; 32 bits as (H, W, 3) under BI_RGB (the fourth byte dropped) and
  as (H, W, 4), the bytes as stored, under BI_BITFIELDS with the masks of
  B, G, R, A bytes (what cv2 writes; other masks raise `Unsupported`);
- a core header makes every image grey (cv2 never sees colour there):
  cv2's BGR→grey weights on the pixels or the palette.
Other header sizes, bit depths, compressions (BI_JPEG, BI_PNG) and
16-bit masks raise `Unsupported`; a file whose data end early raises a
ValueError, as cv2 fails on it.
"""

from __future__ import annotations

import struct

import numpy as np

from .raster import Unsupported, bgr_to_grey, bmp_rle, check_size, is_colour_palette, \
    unpack_indices, with_palette

_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_MASKS = {(0x7C00, 0x3E0, 0x1F): 15, (0xF800, 0x7E0, 0x1F): 16}


def is_bmp(blob: bytes) -> bool:
    return blob[:2] == b"BM"


def _need(blob: bytes, end: int, what: str, name: str) -> None:
    if end > len(blob):
        raise ValueError(f"{name}: a truncated BMP: its {what} runs past the end")


def decode_bmp(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 (H, W, 1), (H, W, 3) RGB or (H, W, 4) RGBA; `name` labels the
    errors."""
    if not is_bmp(blob):
        raise ValueError(f"{name}: not a BMP file")
    _need(blob, 18, "file header", name)
    offset, size = struct.unpack_from("<iI", blob, 10)
    colour, palette = True, None
    if size >= 36 and size < 1 << 31:
        _need(blob, 50, "info header", name)
        w, h = struct.unpack_from("<ii", blob, 18)
        bits, comp = struct.unpack_from("<HI", blob, 28)
        used = struct.unpack_from("<i", blob, 46)[0]
        pos = 14 + size
        if comp > _BITFIELDS:
            raise Unsupported(f"{name}: a BMP with compression {comp} (BI_JPEG, BI_PNG or "
                              "later); cv2 reads BI_RGB, BI_RLE8, BI_RLE4 and BI_BITFIELDS")
        ok = ((bits in (1, 4, 8, 24, 32) and comp == _RGB) or
              (bits in (16, 32) and comp in (_RGB, _BITFIELDS)) or
              (bits == 4 and comp == _RLE4) or (bits == 8 and comp == _RLE8))
        if not ok:
            raise Unsupported(f"{name}: a BMP of {bits} bits a pixel with compression {comp}")
        if bits <= 8:
            if not 0 <= used <= 256:
                raise ValueError(f"{name}: a BMP palette of {used} colours")
            n = used or 1 << bits
            _need(blob, pos + 4 * n, "palette", name)
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(blob, np.uint8, 4 * n, pos).reshape(n, 4)[:, :3]
            colour = is_colour_palette(palette[:1 << bits])
        elif bits == 16:
            if comp == _BITFIELDS:
                _need(blob, pos + 12, "bit masks", name)
                masks = struct.unpack_from("<III", blob, pos)
                if masks not in _MASKS:
                    raise Unsupported(f"{name}: a 16-bit BMP with the masks "
                                      f"{tuple(hex(m) for m in masks)}; cv2 reads 5-5-5 and 5-6-5")
                bits = _MASKS[masks]
            else:
                bits = 15
        elif bits == 32 and comp == _BITFIELDS:
            # right after an INFO header, or in a V2+ one (V3+: and the alpha mask)
            n = 4 if size >= 56 else 3
            _need(blob, 54 + 4 * n, "bit masks", name)
            masks = struct.unpack_from(f"<{n}I", blob, 54)
            if masks != (0xFF0000, 0xFF00, 0xFF, 0xFF000000)[:n]:
                raise Unsupported(f"{name}: a 32-bit BMP with the masks "
                                  f"{tuple(hex(m) for m in masks)}; only B, G, R, A bytes decode")
        channels = 1 if not colour else (4 if bits == 32 and comp != _RGB else 3)
    elif size == 12:
        _need(blob, 26, "core header", name)
        w, h, _, bits = struct.unpack_from("<HHHH", blob, 18)
        comp, colour = _RGB, False
        if bits not in (1, 4, 8, 24, 32):
            raise Unsupported(f"{name}: an OS/2 BMP of {bits} bits a pixel")
        if bits <= 8:
            n = 1 << bits
            _need(blob, 26 + 3 * n, "palette", name)
            palette = np.frombuffer(blob, np.uint8, 3 * n, 26).reshape(n, 3)
        channels = 1
    else:
        raise Unsupported(f"{name}: a BMP header of {size} bytes; cv2 reads 12 and 36 or more")
    bottom_up = h > 0
    h = abs(h)
    check_size(w, h, name, "a BMP")
    if offset < 0 or offset > len(blob):
        raise ValueError(f"{name}: a BMP whose pixel data start at {offset}, past the end")
    if comp in (_RLE8, _RLE4):
        idx = bmp_rle(blob[offset:], w, h, bits, name)
        img = with_palette(idx, palette, colour)
        return np.ascontiguousarray(img[::-1]) if bottom_up else img
    pitch = ((w * (16 if bits == 15 else bits) + 7) // 8 + 3) & -4
    _need(blob, offset + pitch * h, "pixel data", name)
    rows = np.frombuffer(blob, np.uint8, pitch * h, offset).reshape(h, pitch)
    if bottom_up:
        rows = rows[::-1]
    if bits <= 8:
        return with_palette(unpack_indices(rows, bits, w), palette, colour)
    if bits in (15, 16):
        t = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
        if bits == 15:
            b, g, r = t << 3, (t >> 2) & ~7, (t >> 7) & ~7
        else:
            b, g, r = t << 3, (t >> 3) & ~3, (t >> 8) & ~7
        return np.stack([r, g, b], axis=-1).astype(np.uint8)
    px = rows[:, :w * (bits // 8)].reshape(h, w, bits // 8)
    if channels == 1:
        return bgr_to_grey(px)[..., None]
    if channels == 4:
        return np.ascontiguousarray(px[..., [2, 1, 0, 3]])
    return np.ascontiguousarray(px[..., 2::-1])


def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_bmp(f.read(), path)
