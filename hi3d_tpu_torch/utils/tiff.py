"""TIFF decoder without cv2 or PIL, as `cv2.imdecode(...,
cv2.IMREAD_UNCHANGED)` reads an 8-bit TIFF (OpenCV's TiffDecoder through
libtiff's RGBA interface, TIFFReadRGBAStrip/TIFFReadRGBATile), bit for bit,
as RGB(A). The first IFD, in either byte order; multi-page files give
their first page.

- Layout: strips (RowsPerStrip defaulting to the whole image, a shorter
  last strip) or tiles (cropped at the right and bottom), PlanarConfiguration
  1 and 2, FillOrder 2 (the bits of each raw byte reversed, as libtiff
  does for every compression but JPEG).
- Compression: none, LZW (both forms), Deflate (8, 32946; `zlib`),
  PackBits (`csrc/raster_decode.c`), and JPEG (7): each strip or tile a
  JPEG of its own through `utils/jpeg.py`, the JPEGTables tag spliced in
  front of an abbreviated stream. libtiff has libjpeg convert YCbCr to RGB
  (JPEGCOLORMODE_RGB) with its default fancy upsampling; the components
  of any other photometric come back as they are. Predictor 2 at 8 bits.
- What libtiff's RGBA interface makes of the samples, and cv2 of that:
  MinIsBlack and MinIsWhite at 1 and 8 bits (cv2 5.0 refuses 2 and 4)
  through libtiff's map (x·255 // (2^bits − 1), or its reverse) and
  (H, W, 1); palettes at 4 and 8 bits through the colour map (16-bit
  entries shifted down by 8, unless every entry is below 256) and
  (H, W, 3), at 1 bit as (H, W, 1) of the colours' grey levels; RGB and YCbCr-under-JPEG as
  (H, W, 3), with a fourth sample (H, W, 4): associated alpha as stored,
  an unspecified extra sample as associated (libtiff's default for four
  RGB samples too), unassociated alpha premultiplied, (c·a + 127) // 255;
  CMYK (InkSet CMYK) as (H, W, 4), each of R, G, B (255 − K)(255 − x) // 255
  and alpha 255.
More than 8 bits a sample (cv2 returns uint16 or float) raises a
ValueError on every host (ROADMAP §3). BigTIFF, CCITT, old-style JPEG (6),
other compressions and photometrics, uncompressed YCbCr, an Orientation
other than top-left and signed samples raise `Unsupported`; corrupt or
truncated data raise a ValueError, as libtiff fails on them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from .jpeg import decode_jpeg
from .raster import Unsupported, bgr_to_grey, check_size, packbits, predict8, tiff_lzw, \
    unpack_indices

_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 7: ("B", 1),
          8: ("h", 2), 9: ("i", 4), 16: ("Q", 8), 17: ("q", 8)}
_COMPRESSION = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4", 6: "old-style JPEG",
                32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24", 34712: "JPEG 2000",
                34925: "LZMA", 50000: "Zstandard", 50001: "WebP", 34892: "lossy JPEG DNG"}
_PHOTOMETRIC = {4: "transparency mask", 8: "CIELab", 9: "ICCLab", 10: "ITULab",
                32844: "LogL", 32845: "LogLuv", 32803: "CFA", 34892: "LinearRaw"}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def is_tiff(blob: bytes) -> bool:
    return blob[:4] in (b"II*\x00", b"MM\x00*")


_SCALARS = (256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323, 332)
_READ = set(_SCALARS) | {258, 273, 279, 320, 324, 325, 338, 339, 530}  # integer tags read here
_ASCII = {269, 270, 271, 272, 285, 305, 306, 315, 316, 33432}  # libtiff's ASCII tags
_KNOWN_TYPES = set(range(1, 14)) | {16, 17, 18}


def _ifd(blob: bytes, order: str, at: int, name: str) -> Tuple[int, int]:
    """An IFD's entry count and the offset of the next IFD."""
    if at + 2 > len(blob):
        raise ValueError(f"{name}: a TIFF IFD at {at}, past the end")
    (n,) = struct.unpack_from(order + "H", blob, at)
    if at + 6 + 12 * n > len(blob):
        raise ValueError(f"{name}: a truncated TIFF IFD")
    return n, struct.unpack_from(order + "I", blob, at + 2 + 12 * n)[0]


def _tags(blob: bytes, name: str) -> Dict[int, tuple]:
    """The first IFD's tags (values as tuples; a repeated tag keeps its
    first entry, as libtiff does). The chain of IFDs is walked, as libtiff
    walks it for cv2, and a broken one raises."""
    order = "<" if blob[:2] == b"II" else ">"
    if len(blob) < 8:
        raise ValueError(f"{name}: a truncated TIFF header")
    (ifd,) = struct.unpack_from(order + "I", blob, 4)
    n, nxt = _ifd(blob, order, ifd, name)
    seen = {ifd}
    while nxt:
        if nxt in seen or len(seen) > 65535:
            raise ValueError(f"{name}: a TIFF whose IFDs loop")
        seen.add(nxt)
        nxt = _ifd(blob, order, nxt, name)[1]
    tags = {}
    for i in range(n):
        tag, kind, count = struct.unpack_from(order + "HHI", blob, ifd + 2 + 12 * i)
        if kind not in _KNOWN_TYPES or (tag in _ASCII and kind != 2) or \
                (tag in _READ and kind not in (1, 3, 4, 8, 9, 16, 17)):
            raise ValueError(f"{name}: a TIFF tag {tag} of type {kind}")
        if kind not in _TYPES or not count or tag in tags:
            continue  # rationals, floats: no tag read here has them
        if tag in _SCALARS and count != 1:
            raise ValueError(f"{name}: a TIFF tag {tag} of {count} values")
        fmt, size = _TYPES[kind]
        at = ifd + 2 + 12 * i + 8
        if size * count > 4:
            (at,) = struct.unpack_from(order + "I", blob, at)
        if at + size * count > len(blob):
            raise ValueError(f"{name}: a TIFF tag {tag} whose values run past the end")
        tags[tag] = blob[at:at + count] if tag == 347 else \
            struct.unpack_from(f"{order}{count}{fmt}", blob, at)
    return tags


def _one(tags: Dict[int, tuple], tag: int, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


def _decompress(raw: bytes, comp: int, occ: int, name: str) -> np.ndarray:
    """One strip or tile's first `occ` bytes, decompressed."""
    if comp == 1:
        if len(raw) < occ:
            raise ValueError(f"{name}: a TIFF strip of {len(raw)} bytes, {occ} expected")
        return np.frombuffer(raw, np.uint8, occ)
    if comp == 5:
        return tiff_lzw(raw, occ, name)
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, occ)
        except zlib.error as e:
            raise ValueError(f"{name}: corrupt TIFF Deflate data: {e}") from None
        if len(out) < occ:
            raise ValueError(f"{name}: corrupt TIFF Deflate data: {len(out)} of {occ} bytes")
        return np.frombuffer(out, np.uint8)
    if comp == 32773:
        return packbits(raw, occ, name)
    raise AssertionError(comp)


def decode_tiff(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 (H, W, 1), (H, W, 3) RGB or (H, W, 4) RGBA; `name` labels the
    errors."""
    if blob[:4] in (b"II+\x00", b"MM\x00+"):
        raise Unsupported(f"{name}: a BigTIFF; only classic TIFFs decode")
    if not is_tiff(blob):
        raise ValueError(f"{name}: not a TIFF file")
    tags = _tags(blob, name)
    w, h = _one(tags, 256, 0), _one(tags, 257, 0)
    bits = tags.get(258, (1,))
    spp = _one(tags, 277, 1)
    comp = _one(tags, 259, 1)
    photo = _one(tags, 262)
    planar = _one(tags, 284, 1)
    formats = tags.get(339, (1,))
    fmt = formats[0]
    if len(set(formats)) != 1:
        raise ValueError(f"{name}: a TIFF with SampleFormat {formats}")
    check_size(w, h, name, "a TIFF")
    if not spp:
        raise ValueError(f"{name}: a TIFF of 0 samples a pixel")
    if len(set(bits)) != 1 or len(bits) not in (1, spp):
        raise ValueError(f"{name}: a TIFF with BitsPerSample {bits}")
    bits = bits[0]
    if bits > 8 or fmt == 3:
        kind = "float" if fmt == 3 else f"{bits}-bit"
        raise ValueError(f"{name}: a {kind} TIFF; cv2 returns it as {kind}, which the JAX "
                         "package's / 255 mishandles, so the port reads 8-bit TIFFs only")
    if fmt != 1:
        raise Unsupported(f"{name}: a TIFF of SampleFormat {fmt}")
    if bits not in (1, 8) and not (bits == 4 and photo == 3):  # cv2 5.0 refuses the rest
        raise Unsupported(f"{name}: a TIFF of {bits} bits a sample and photometric {photo}; "
                          "cv2 reads 1 and 8 bits, and 4-bit palettes")
    if comp in _COMPRESSION or comp not in (1, 5, 7, 8, 32773, 32946):
        raise Unsupported(f"{name}: a TIFF compressed as {_COMPRESSION.get(comp, comp)}")
    if photo is None or photo in _PHOTOMETRIC or photo not in (0, 1, 2, 3, 5, 6):
        raise Unsupported(f"{name}: a TIFF of photometric "
                          f"{_PHOTOMETRIC.get(photo, photo)}")
    if _one(tags, 274, 1) != 1:
        raise Unsupported(f"{name}: a TIFF of Orientation {_one(tags, 274)}; only top-left "
                          "(1) decodes")
    if planar not in (1, 2):
        raise ValueError(f"{name}: a TIFF of PlanarConfiguration {planar}")
    if spp == 1:
        planar = 1
    extras = tags.get(338, ())
    if any(e > 2 for e in extras):
        raise ValueError(f"{name}: a TIFF with ExtraSamples {extras}")
    alpha = extras[0] if extras else None
    if not extras and spp == 4 and photo == 2:  # libtiff's DEFAULT_EXTRASAMPLE_AS_ALPHA
        alpha = 1
    if alpha == 0 and spp > 3:
        alpha = 1
    colours = spp - (len(extras) if extras else int(spp == 4 and photo == 2))
    if spp > 4:
        raise Unsupported(f"{name}: a TIFF of {spp} samples a pixel; cv2 reads up to 4")
    if photo in (0, 1, 3) and (bits < 8 or planar == 2 or 322 in tags) and spp != 1:
        raise Unsupported(f"{name}: a {bits}-bit grey or palette TIFF of {spp} samples a "
                          f"pixel in PlanarConfiguration {planar}, or tiled")
    if photo in (2, 5, 6) and bits != 8:
        raise Unsupported(f"{name}: a TIFF of photometric {photo} at {bits} bits a sample")
    if photo == 2 and colours < 3:
        raise Unsupported(f"{name}: an RGB TIFF of {colours} colour samples")
    if photo == 5 and (_one(tags, 332, 1) != 1 or colours < 4):
        raise Unsupported(f"{name}: a separated TIFF that is not CMYK")
    if photo == 6 and (comp != 7 or planar != 1):
        raise Unsupported(f"{name}: a YCbCr TIFF not compressed as JPEG; only YCbCr under "
                          "JPEG decodes")
    subsampling = tags.get(530, (2, 2))
    if photo == 6 and (len(subsampling) != 2 or subsampling[0] not in (1, 2, 4) or
                       subsampling[1] not in (1, 2, 4) or subsampling[1] > subsampling[0]):
        raise ValueError(f"{name}: a TIFF with YCbCrSubsampling {subsampling}")
    if photo == 3 and 320 not in tags:
        raise ValueError(f"{name}: a palette TIFF without a ColorMap")
    if comp == 7 and (bits != 8 or planar != 1):
        raise Unsupported(f"{name}: a JPEG-compressed TIFF of {bits}-bit samples in "
                          f"PlanarConfiguration {planar}")
    predictor = _one(tags, 317, 1)
    if predictor not in (1, 2) or (predictor == 2 and comp not in (5, 8, 32946)) or \
            (predictor == 2 and bits != 8):
        raise Unsupported(f"{name}: a TIFF predictor {predictor} with compression {comp} at "
                          f"{bits} bits")
    samples = _samples(blob, tags, w, h, bits, spp, comp, photo, planar, name)
    rgba = _rgba(samples, tags, bits, spp, photo, alpha, name)
    if photo in (0, 1) or bits == 1:  # cv2's grey: its BGR→grey weights on libtiff's RGBA
        return bgr_to_grey(rgba[..., 2::-1])[..., None]
    return np.ascontiguousarray(rgba[..., :3] if photo == 3 or spp == 3 else rgba)


def _chunks(tags, w, h, tiled: bool, name: str):
    """(offsets, byte counts, chunk width, chunk height, chunks across,
    chunks down) of the strips or tiles."""
    if tiled:
        cw, ch = _one(tags, 322, 0), _one(tags, 323, 0)
        offsets, counts = tags.get(324), tags.get(325)
        if not cw or not ch or cw * ch > 4 * w * h + (1 << 16):
            raise ValueError(f"{name}: a TIFF tile of {cw}×{ch} pixels in a {w}×{h} image")
    else:
        cw, ch = w, min(_one(tags, 278, h) or h, h)
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None or len(offsets) != len(counts):
        raise ValueError(f"{name}: a TIFF without its strip or tile offsets and byte counts")
    return offsets, counts, cw, ch, -(-w // cw), -(-h // ch)


def _samples(blob, tags, w, h, bits, spp, comp, photo, planar, name) -> np.ndarray:
    """The image's samples, (h, w, spp) uint8 (bits < 8: (h, w, 1) of the
    unpacked values)."""
    tiled = 322 in tags
    offsets, counts, cw, ch, across, down = _chunks(tags, w, h, tiled, name)
    planes = spp if planar == 2 else 1
    per_plane = 1 if planar == 2 else spp
    if len(offsets) < across * down * planes:
        raise ValueError(f"{name}: a TIFF of {len(offsets)} strips or tiles, "
                         f"{across * down * planes} needed")
    tables = tags.get(347, b"")
    reverse = _one(tags, 266, 1) == 2 and comp != 7
    predict = _one(tags, 317, 1) == 2
    row_bytes = (cw * bits * per_plane + 7) // 8
    out = np.zeros((h, w, spp if bits == 8 else 1), np.uint8)
    for p in range(planes):
        for j in range(down):
            for i in range(across):
                k = p * across * down + j * across + i
                rows = ch if tiled else min(ch, h - j * ch)
                start, size = offsets[k], counts[k]
                if start + size > len(blob):
                    raise ValueError(f"{name}: a TIFF strip or tile that runs past the end")
                raw = blob[start:start + size]
                if reverse:
                    raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
                if comp == 1 and tiled and row_bytes * rows != 4 * cw * ch:
                    # libtiff under cv2 reads an uncompressed tile as 4 bytes a pixel
                    raise ValueError(f"{name}: an uncompressed TIFF tile of {row_bytes * rows} "
                                     f"bytes, which cv2 fails to read (it asks for "
                                     f"{4 * cw * ch})")
                if comp == 7:
                    chunk = _jpeg(raw, tables, photo, cw, rows, per_plane,
                                  tags.get(530, (2, 2)), name)
                else:
                    data = _decompress(raw, comp, row_bytes * rows, name)
                    data = np.array(data[:row_bytes * rows]).reshape(rows, row_bytes)
                    if predict:
                        predict8(data, per_plane)
                    if bits == 8:
                        chunk = data[:, :cw * per_plane].reshape(rows, cw, per_plane)
                    else:
                        chunk = unpack_indices(data, bits, cw)[..., None]
                y0, x0 = j * ch, i * cw
                y1, x1 = min(y0 + rows, h), min(x0 + cw, w)
                dst = out[y0:y1, x0:x1]
                if planar == 2:
                    dst[..., p] = chunk[:y1 - y0, :x1 - x0, 0]
                else:
                    dst[...] = chunk[:y1 - y0, :x1 - x0]
    return out


def _jpeg(raw: bytes, tables: bytes, photo: int, cw: int, rows: int, components: int,
          subsampling, name: str) -> np.ndarray:
    """A JPEG strip or tile → (rows, cw, components): YCbCr to RGB, any
    other photometric's components raw; JPEGTables spliced in front. As in
    libtiff, a YCbCr stream's luma sampling must be YCbCrSubsampling's and
    any other photometric's components must all be sampled 1×1."""
    if tables and len(tables) >= 4 and tables[:2] == b"\xff\xd8" and raw[:2] == b"\xff\xd8":
        raw = tables[:-2] + raw[2:] if tables[-2:] == b"\xff\xd9" else tables + raw[2:]
    factors = _sampling(raw)
    want = [subsampling[0] << 4 | subsampling[1]] if photo == 6 else [0x11] * len(factors)
    if factors[:len(want)] != want:
        raise ValueError(f"{name}: a TIFF JPEG strip or tile sampled "
                         f"{[hex(f) for f in factors]}, {[hex(f) for f in want]} expected")
    img = decode_jpeg(raw, name, colour="ycc" if photo == 6 else "raw")
    if img.shape != (rows, cw, 3 if photo == 6 else components):
        raise ValueError(f"{name}: a TIFF JPEG strip or tile of {img.shape}, "
                         f"{(rows, cw, components)} expected")
    return img


def _sampling(stream: bytes) -> list:
    """The components' sampling bytes in a JPEG's frame header ([] before
    one is found)."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        kind, length = stream[pos + 1], int.from_bytes(stream[pos + 2:pos + 4], "big")
        if kind in (0xC0, 0xC1, 0xC2):
            frame = stream[pos + 4:pos + 2 + length]
            return [frame[7 + 3 * i] for i in range(frame[5]) if 8 + 3 * i <= len(frame)] \
                if len(frame) > 5 else []
        pos += 2 + length
    return []


def _colour_map(tags, bits: int, name: str) -> np.ndarray:
    """The (2^bits, 3) RGB palette as libtiff's RGBA interface builds it:
    16-bit entries >> 8, unless every entry is below 256 (then 8-bit)."""
    cmap = np.asarray(tags[320], np.int64)
    n = 1 << bits
    if cmap.size != 3 * n:
        raise ValueError(f"{name}: a TIFF ColorMap of {cmap.size} entries, {3 * n} expected")
    cmap = cmap.reshape(3, n).T
    if (cmap >= 256).any():
        cmap = cmap >> 8
    return cmap.astype(np.uint8)


def _rgba(samples: np.ndarray, tags, bits: int, spp: int, photo: int, alpha,
          name: str) -> np.ndarray:
    """libtiff's RGBA raster of the samples, (h, w, 4) in R, G, B, A order."""
    h, w = samples.shape[:2]
    rgba = np.full((h, w, 4), 255, np.uint8)
    if photo in (0, 1):
        rng = (1 << bits) - 1
        x = np.arange(rng + 1)
        lut = ((rng - x if photo == 0 else x) * 255 // rng).astype(np.uint8)
        rgba[..., :3] = lut[samples[..., :1]]
        if bits == 8 and spp == 2 and alpha:  # putagreytile: alpha as stored
            rgba[..., 3] = samples[..., 1]
    elif photo == 3:
        rgba[..., :3] = _colour_map(tags, bits, name)[samples[..., 0]]
    elif photo in (2, 6):
        rgba[..., :3] = samples[..., :3]
        if spp >= 4 and alpha in (1, 2):
            a = samples[..., 3]
            rgba[..., 3] = a
            if alpha == 2:  # unassociated: premultiplied, (v·a + 127) / 255
                rgba[..., :3] = ((samples[..., :3].astype(np.int32) * a[..., None].astype(
                    np.int32) + 127) // 255).astype(np.uint8)
    else:  # CMYK
        k = 255 - samples[..., 3:4].astype(np.int32)
        rgba[..., :3] = (k * (255 - samples[..., :3].astype(np.int32)) // 255).astype(np.uint8)
    return rgba


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_tiff(f.read(), path)
