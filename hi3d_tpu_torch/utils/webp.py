"""WebP decoder without cv2 or PIL (counterpart of the JAX package's WebP
reads through cv2: hi3d_tpu/utils/image.py:31-42 `load_image_rgb`,
hi3d_tpu/data/video_dataset.py:49-66, and the serve CLI's `*.webp` glob,
hi3d_tpu/pipelines/serve.py:446).

`decode_webp` gives what `cv2.imdecode(..., cv2.IMREAD_UNCHANGED)` gives with
OpenCV's libwebp (`WebPDecodeBGRInto`/`WebPDecodeBGRAInto`, fancy upsampling
on), bit for bit, as RGB: (H, W, 4) RGBA when cv2 sees alpha (a VP8X
chunk's alpha flag, opaque where no ALPH chunk comes with a lossy image;
without VP8X, a lossless header's alpha bit), else (H, W, 3) RGB — a WebP
written from a grey image too.

Scope: the RIFF container with a `VP8 ` (lossy), `VP8L` (lossless) or
`VP8X` header, ALPH chunks (raw or lossless-compressed, with the
horizontal, vertical or gradient filter), ICC, EXIF, XMP and unknown chunks
skipped. An animated file (a VP8X with the animation flag, ANIM and ANMF
chunks) gives its first frame as cv2 reads it through libwebp's
WebPAnimDecoder: the frame (lossy, with or without ALPH, or lossless)
decoded as RGBA into a transparent black canvas at its offset, the canvas
RGBA when the VP8X alpha flag is set, else its RGB; every frame is checked
as libwebp's demuxer checks it (ANIM before the frames, each frame's
bitstream header and its place inside the canvas). A malformed or truncated
file raises a ValueError.

The bitstreams decode in C (`csrc/webp_decode.c`, built at first use by
`utils.cbuild`): the VP8L decoder, which also reads the lossless alpha
planes, the alpha unfiltering, and the VP8 key-frame decoder with libwebp's
fancy upsampler and fixed-point YUV→RGB.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import cbuild
from .raster import check_size

_ERRORS = {-1: "the data end before the image does", -2: "a code, size or value the format "
           "does not allow", -3: "out of memory", -4: "sizes that disagree"}
_ANIMATION, _ALPHA = 0x02, 0x10  # VP8X flags
_VP8X_FLAGS = 0x3E  # the flags libwebp's demuxer knows: ICC, alpha, EXIF, XMP, animation
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _native() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cbuild.load("webp_decode.c", "hi3d_webp", "decode_webp")
            p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            lib.hi3d_webp_lossless.argtypes = [p, l, i, i, i, p]
            lib.hi3d_webp_lossy.argtypes = [p, l, i, i, p, i]
            lib.hi3d_webp_unfilter_alpha.argtypes = [p, i, i, i]
            for fn in (lib.hi3d_webp_lossless, lib.hi3d_webp_lossy, lib.hi3d_webp_unfilter_alpha):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def is_webp(blob: bytes) -> bool:
    return len(blob) >= 12 and blob[:4] == b"RIFF" and blob[8:12] == b"WEBP"


def _check(err: int, what: str, name: str) -> None:
    if err:
        raise ValueError(f"{name}: corrupt WebP {what}: {_ERRORS.get(err, err)}")


def _lossless(payload: bytes, w: int, h: int, headerless: bool, name: str, what: str):
    argb = np.empty((h, w), np.uint32)
    buf = np.frombuffer(payload, np.uint8)
    _check(_native().hi3d_webp_lossless(buf.ctypes.data, buf.size, int(headerless), w, h,
                                        argb.ctypes.data), what, name)
    return argb


def _alpha(alph: bytes, w: int, h: int, name: str) -> np.ndarray:
    """An ALPH chunk's plane (h, w): its header byte, then raw bytes or a
    headerless VP8L stream (alpha in green), then the filter undone."""
    if len(alph) <= 1:
        raise ValueError(f"{name}: an empty WebP ALPH chunk")
    method, filt, pre, rsrv = alph[0] & 3, (alph[0] >> 2) & 3, (alph[0] >> 4) & 3, alph[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError(f"{name}: a WebP ALPH chunk with compression {method}, "
                         f"preprocessing {pre} and reserved bits {rsrv}")
    if method == 0:
        if len(alph) - 1 < w * h:
            raise ValueError(f"{name}: a raw WebP ALPH chunk of {len(alph) - 1} bytes for "
                             f"{w}×{h} pixels")
        plane = np.frombuffer(alph, np.uint8, w * h, 1).reshape(h, w).copy()
    else:
        plane = ((_lossless(alph[1:], w, h, True, name, "alpha") >> 8) & 0xFF).astype(np.uint8)
    _check(_native().hi3d_webp_unfilter_alpha(plane.ctypes.data, w, h, filt), "alpha", name)
    return plane


def _vp8_size(body: bytes, name: str):
    """VP8GetInfo: a displayable key frame's width and height."""
    if len(body) < 10:
        raise ValueError(f"{name}: a truncated WebP VP8 header")
    bits = body[0] | body[1] << 8 | body[2] << 16
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= len(body) or \
            body[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: a WebP VP8 chunk that is no displayable key frame")
    w, h = (body[7] << 8 | body[6]) & 0x3FFF, (body[9] << 8 | body[8]) & 0x3FFF
    if not w or not h:
        raise ValueError(f"{name}: a WebP of {w}×{h} pixels")
    return w, h


def _vp8l_size(body: bytes, name: str):
    """VP8LGetInfo: width, height and the alpha bit."""
    if len(body) < 5 or body[0] != 0x2F or body[4] >> 5:
        raise ValueError(f"{name}: a WebP VP8L chunk without its signature")
    bits = int.from_bytes(body[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def decode_webp(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 (H, W, 3) RGB or (H, W, 4) RGBA; `name` labels the errors."""
    if not is_webp(blob):
        raise ValueError(f"{name}: not a WebP file")
    if len(blob) < 32:  # cv2's WEBP_HEADER_SIZE
        raise ValueError(f"{name}: a WebP of {len(blob)} bytes; cv2 reads none under 32")
    riff = int.from_bytes(blob[4:8], "little")
    if riff < 12:
        raise ValueError(f"{name}: a WebP RIFF size of {riff} bytes, too small")
    if riff > len(blob) - 8:
        raise ValueError(f"{name}: a truncated WebP: its RIFF size is {riff} bytes, "
                         f"the file holds {len(blob) - 8}")
    data, pos = blob[:8 + riff], 12
    vp8x = alph = None

    def chunk(at: int):
        if at + 8 > len(data):
            raise ValueError(f"{name}: a truncated WebP: no image chunk")
        kind, size = data[at:at + 4], int.from_bytes(data[at + 4:at + 8], "little")
        if at + 8 + size > len(data):
            raise ValueError(f"{name}: a truncated WebP: its {kind!r} chunk runs past the end")
        return kind, data[at + 8:at + 8 + size], at + 8 + size + (size & 1)

    start = pos + 8
    kind, body, pos = chunk(pos)
    if kind == b"VP8X":
        if len(body) != 10:
            raise ValueError(f"{name}: a WebP VP8X chunk of {len(body)} bytes (10 expected)")
        vp8x = (body[0], 1 + int.from_bytes(body[4:7], "little"),
                1 + int.from_bytes(body[7:10], "little"))
        if vp8x[0] & _ANIMATION:
            return _first_frame(data, pos, vp8x, name)
        # ICC, EXIF, XMP and unknown chunks skipped (ANIM and ANMF too, in a
        # file without the animation flag); the last ALPH kept
        while True:
            start = pos + 8
            kind, body, pos = chunk(pos)
            if kind in (b"VP8 ", b"VP8L"):
                break
            if kind == b"ALPH":
                alph = body
    # cv2 takes the channels from WebPGetFeatures on the first 32 bytes: a VP8X
    # chunk's alpha flag, else a lossless header's alpha bit
    if kind == b"VP8L":
        w, h, has_alpha = _vp8l_size(body, name)
        if vp8x is not None:
            has_alpha = bool(vp8x[0] & _ALPHA)
    elif kind == b"VP8 ":
        (w, h), has_alpha = _vp8_size(body, name), bool(vp8x and vp8x[0] & _ALPHA)
    else:
        raise ValueError(f"{name}: a WebP whose first chunk is {kind!r}, not VP8, VP8L or VP8X")
    if vp8x is not None and vp8x[1:] != (w, h):
        raise ValueError(f"{name}: a WebP canvas of {vp8x[1]}×{vp8x[2]} around an image of "
                         f"{w}×{h}")
    # libwebp's decoders read on from the image chunk to the end of the file
    stream = blob[start:]
    if kind == b"VP8L":
        argb = _lossless(stream, w, h, False, name, "lossless image")
        shifts = (16, 8, 0, 24) if has_alpha else (16, 8, 0)
        return np.stack([(argb >> s).astype(np.uint8) for s in shifts], axis=-1)
    out = np.empty((h, w, 4 if has_alpha else 3), np.uint8)
    buf = np.frombuffer(stream, np.uint8)
    _check(_native().hi3d_webp_lossy(buf.ctypes.data, buf.size, w, h, out.ctypes.data,
                                     out.shape[-1]), "lossy image", name)
    if alph is not None:  # decoded, and failing, whether it is shown or not
        plane = _alpha(alph, w, h, name)
        if has_alpha:
            out[..., 3] = plane
    return out


class _Chunks:
    """A cursor over a RIFF body as libwebp's demuxer walks it: each chunk
    header read from the cursor, its padded payload inside the data."""

    def __init__(self, data: bytes, pos: int, name: str):
        self.data, self.pos, self.name = data, pos, name

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def next(self):
        """(kind, size, padded size) of the chunk at the cursor, which moves
        past its header."""
        if len(self.data) - self.pos < 8:
            self.fail("a truncated WebP: a chunk header runs past the end")
        kind = self.data[self.pos:self.pos + 4]
        size = int.from_bytes(self.data[self.pos + 4:self.pos + 8], "little")
        padded = size + (size & 1)
        self.pos += 8
        if padded > len(self.data) - self.pos:
            self.fail(f"a truncated WebP: its {kind!r} chunk runs past the end")
        return kind, size, padded

    def more(self) -> bool:
        """After a chunk: False at the end of the data; a partial chunk
        header there fails."""
        if self.pos == len(self.data):
            return False
        if len(self.data) - self.pos < 8:
            self.fail("a truncated WebP: a chunk header runs past the end")
        return True


def _frame(c: _Chunks, payload: int, canvas, index: int):
    """The chunks of an ANMF frame as libwebp's demuxer stores them (its
    StoreFrame), from the cursor: an ALPH, then a VP8 or a VP8L chunk, the
    walk ending at any other chunk, which the file's own walk then reads.
    Returns (x, y, w, h, alpha, image kind, image payload padded), w and h
    the bitstream's; None for a frame without chunks, which the demuxer
    drops."""
    where = f"WebP frame {index}"
    head = c.data[c.pos:c.pos + 16]
    x, y = 2 * int.from_bytes(head[0:3], "little"), 2 * int.from_bytes(head[3:6], "little")
    c.pos += 16
    start, alph, image = c.pos, None, None
    if len(c.data) - start < max(payload, 8):
        c.fail(f"a truncated WebP: {where} runs past the end")
    while True:
        at = c.pos
        kind, size, padded = c.next()
        if kind == b"ALPH" and alph is None and image is None:
            alph = c.data[c.pos:c.pos + size]
        elif kind in (b"VP8 ", b"VP8L") and image is None:
            if kind == b"VP8L" and alph is not None:
                c.fail(f"{where}: an ALPH chunk before a lossless image")
            image = kind, c.data[c.pos:c.pos + padded], size
        else:  # the frame ends here
            c.pos = at
            break
        c.pos += padded
        if not c.more():
            break
    if c.pos - start > payload:
        c.fail(f"{where}: chunks past the end of its ANMF chunk")
    if image is None:
        if alph is not None:
            c.fail(f"{where}: an ALPH chunk without an image")
        return None
    kind, body, size = image
    if kind == b"VP8L":
        w, h, _ = _vp8l_size(body[:size], c.name)
    else:
        w, h = _vp8_size(body[:size], c.name)
    if x + w > canvas[0] or y + h > canvas[1]:
        c.fail(f"{where}: {w}×{h} at ({x}, {y}) outside the {canvas[0]}×{canvas[1]} canvas")
    return x, y, w, h, alph, kind, body


def _first_frame(data: bytes, pos: int, vp8x, name: str) -> np.ndarray:
    """An animated WebP's first frame as cv2 reads it: WebPAnimDecoder (its
    demuxer's walk and checks of every chunk and frame, then the first
    frame decoded as RGBA into a zeroed canvas), RGBA where the VP8X alpha
    flag is set, else RGB."""
    flags, cw, ch = vp8x
    check_size(cw, ch, name, "an animated WebP canvas")
    if flags & ~_VP8X_FLAGS:
        raise ValueError(f"{name}: a WebP VP8X chunk with unknown flags 0x{flags:02x}")
    c = _Chunks(data, pos, name)
    frames, anim = [], False
    while c.more():
        kind, size, padded = c.next()
        if kind in (b"VP8X", b"ALPH", b"VP8 ", b"VP8L"):
            c.fail(f"an animated WebP with a {kind!r} chunk outside its frames")
        if kind == b"ANMF":
            if not anim:
                c.fail("a WebP ANMF chunk before its ANIM chunk")
            if padded < 16:
                c.fail(f"a WebP ANMF chunk of {size} bytes (16 at least)")
            frame = _frame(c, padded - 16, (cw, ch), len(frames) + 1)
            if frame is not None:
                frames.append(frame)
            continue
        if kind == b"ANIM" and padded < 6:
            c.fail(f"a WebP ANIM chunk of {size} bytes (6 at least)")
        anim |= kind == b"ANIM"
        c.pos += padded
    if not frames:
        raise ValueError(f"{name}: an animated WebP without a frame")
    x, y, w, h, alph, kind, payload = frames[0]
    if kind == b"VP8L":
        argb = _lossless(payload, w, h, False, name, "lossless frame")
        rgba = np.stack([(argb >> s).astype(np.uint8) for s in (16, 8, 0, 24)], axis=-1)
    else:
        rgba = np.empty((h, w, 4), np.uint8)
        buf = np.frombuffer(payload, np.uint8)
        _check(_native().hi3d_webp_lossy(buf.ctypes.data, buf.size, w, h, rgba.ctypes.data, 4),
               "lossy frame", name)
        if alph is not None:
            rgba[..., 3] = _alpha(alph, w, h, name)
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[y:y + h, x:x + w] = rgba
    return canvas if flags & _ALPHA else np.ascontiguousarray(canvas[..., :3])


def read_webp(path: str) -> np.ndarray:
    """`decode_webp` of a file."""
    with open(path, "rb") as f:
        return decode_webp(f.read(), path)

