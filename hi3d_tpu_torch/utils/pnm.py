"""PNM decoder without cv2 or PIL: PBM, PGM and PPM, ASCII (P1-P3) and
binary (P4-P6), as `cv2.imdecode(..., cv2.IMREAD_UNCHANGED)` reads them
(OpenCV's PxMDecoder, grfmt_pxm.cpp), bit for bit, as RGB:
- the header's numbers are cv2's ReadNumber: whitespace and `#` comments
  (to the end of the line) before a number, the one byte after it taken
  with it; the data start right after the byte that ends maxval (the
  height for P1 and P4);
- P1 and P4 give 255 for a 0 bit and 0 for a 1 (P1 reads one digit a
  sample, so `101` is three); P2 and P3 samples are clamped to maxval and
  scaled by i·255 // maxval; P5 and P6 bytes come back as stored, whatever
  maxval (cv2 scales only the ASCII forms);
- (H, W, 1) for P1, P2, P4 and P5, (H, W, 3) RGB for P3 and P6.
A maxval above 255 (cv2 returns uint16) raises a ValueError on every host,
as the 16-bit PNGs do (ROADMAP §3: JAX's / 255 mishandles them). PAM (P7)
is utils/pam.py's; the float maps (PF, Pf) are another format, which
`utils.image` names.
"""

from __future__ import annotations

import numpy as np

from .raster import check_size

_SPACE = b" \t\n\v\f\r"
_DIGITS = b"0123456789"


def is_pnm(blob: bytes) -> bool:
    return len(blob) >= 3 and blob[0:1] == b"P" and blob[1:2] in (b"1", b"2", b"3", b"4", b"5",
                                                                 b"6") and blob[2] in _SPACE


class _Reader:
    def __init__(self, blob: bytes, name: str):
        self.blob, self.pos, self.name = blob, 2, name

    def byte(self) -> int:
        if self.pos >= len(self.blob):
            raise ValueError(f"{self.name}: a truncated PNM")
        self.pos += 1
        return self.blob[self.pos - 1]

    def number(self, max_digits: int = 0) -> int:
        """cv2's ReadNumber: skip whitespace and comments, read digits, and
        take the byte after them (not after the last of `max_digits`)."""
        code = self.byte()
        while code not in _DIGITS:
            if code == ord("#"):
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ValueError(f"{self.name}: a PNM with the byte 0x{code:02x} where a number "
                                 "belongs")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > 0x7FFFFFFF:
                raise ValueError(f"{self.name}: a PNM number past 2³¹")
            digits += 1
            if max_digits and digits >= max_digits:
                return val
            code = self.byte()
            if code not in _DIGITS:
                return val


def _ascii(r: _Reader, count: int, single: bool) -> np.ndarray:
    """`count` ASCII samples from the reader's position, as cv2 reads them
    one ReadNumber at a time (one digit a sample for P1); data of digits
    and whitespace alone take a vectorised path to the same values."""
    data = r.blob[r.pos:]
    if data.translate(None, _SPACE + _DIGITS):  # comments or stray bytes: cv2's loop
        return np.array([r.number(1 if single else 0) for _ in range(count)], np.int64)
    if single:
        digits = data.translate(None, _SPACE)
        if len(digits) < count:
            raise ValueError(f"{r.name}: a truncated PNM")
        return np.frombuffer(digits, np.uint8, count).astype(np.int64) - 48
    tokens = data.split()
    if len(tokens) < count or (len(tokens) == count and data[-1] in _DIGITS):
        raise ValueError(f"{r.name}: a truncated PNM")  # the last number runs to the end
    vals = np.array([int(t) for t in tokens[:count]], np.int64)
    if vals.size and vals.max() > 0x7FFFFFFF:
        raise ValueError(f"{r.name}: a PNM number past 2³¹")
    return vals


def decode_pnm(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 (H, W, 1) or (H, W, 3) RGB; `name` labels the errors."""
    if not is_pnm(blob):
        raise ValueError(f"{name}: not a PNM (P1-P6) file")
    kind = blob[1] - 48
    r = _Reader(blob, name)
    w, h = r.number(), r.number()
    maxval = 1 if kind in (1, 4) else r.number()
    if maxval > 255:
        raise ValueError(f"{name}: a 16-bit PNM (maxval {maxval}); cv2 returns uint16, which "
                         "the JAX package's / 255 mishandles, so the port reads 8-bit PNMs only")
    if maxval <= 0:
        raise ValueError(f"{name}: a PNM with maxval {maxval}")
    check_size(w, h, name, "a PNM")
    n = 3 if kind in (3, 6) else 1
    if kind == 4:
        pitch = (w + 7) // 8
        if r.pos + pitch * h > len(blob):
            raise ValueError(f"{name}: a truncated PNM")
        rows = np.frombuffer(blob, np.uint8, pitch * h, r.pos).reshape(h, pitch)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return ((1 - bits) * 255).astype(np.uint8)[..., None]
    if kind in (5, 6):
        if r.pos + w * h * n > len(blob):
            raise ValueError(f"{name}: a truncated PNM")
        return np.frombuffer(blob, np.uint8, w * h * n, r.pos).reshape(h, w, n).copy()
    vals = _ascii(r, w * h * n, kind == 1)
    if kind == 1:
        return np.where(vals.reshape(h, w, 1) != 0, 0, 255).astype(np.uint8)
    lut = (np.arange(maxval + 1) * 255 // maxval).astype(np.uint8)
    return lut[np.minimum(vals, maxval)].reshape(h, w, n)


def read_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_pnm(f.read(), path)
