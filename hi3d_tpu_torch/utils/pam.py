"""PAM (P7) decoder without cv2 or PIL, as `cv2.imdecode(...,
cv2.IMREAD_UNCHANGED)` reads it (OpenCV 5.0's PAMDecoder, grfmt_pam.cpp),
bit for bit, in the port's RGB(A) order:
- the header: "P7" and a newline (LF or CR), then lines of an identifier
  (HEIGHT, WIDTH, DEPTH, MAXVAL, TUPLTYPE, ENDHDR; 8 bytes at most, case as
  written) and a value to the end of the line, its trailing whitespace cut;
  `#` comments and blank lines between them. The numbers are digits alone
  (a leading `-` allowed), each field once, TUPLTYPE as often as wanted (the
  last counts); the data start after the byte that ends the ENDHDR line;
- the tuple types: BLACKANDWHITE and GRAYSCALE (depth 1), GRAYSCALE_ALPHA
  (2), RGB (3), RGB_ALPHA (4), or none: depth 1 or 3 with maxval below 256;
  another combination is refused as cv2 refuses it;
- samples come back as stored, whatever maxval, except at maxval 1, where
  cv2 reads each row's bytes as packed bits (MSB first, 255 for a 1, grey
  replicated to depth 3; depth 2 or 4 fails);
- (H, W, depth) uint8, the channels of depth 3 and 4 reversed as the port
  reverses cv2's BGR(A): cv2 stores the file's samples in its BGR(A) order.
A maxval above 255 (cv2 returns uint16) raises a ValueError on every host,
as 16-bit PNMs do (ROADMAP §3).
"""

from __future__ import annotations

import re

import numpy as np

from .raster import check_size

_SPACE = b" \t\n\v\f\r"
_FIELDS = (b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
_TUPLES = {b"": None, b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
           b"RGB_ALPHA": 4}  # tuple type: its depth (None: guessed)


def is_pam(blob: bytes) -> bool:
    return len(blob) >= 3 and blob[:2] == b"P7" and blob[2] in _SPACE


class _Header:
    def __init__(self, blob: bytes, name: str):
        self.blob, self.pos, self.name = blob, 3, name

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def byte(self) -> int:
        if self.pos >= len(self.blob):
            self.fail("a truncated PAM header")
        self.pos += 1
        return self.blob[self.pos - 1]

    def line(self):
        """cv2's ReadPAMHeaderLine: (identifier, value), or None for a
        comment."""
        code = self.byte()
        while code in _SPACE:
            code = self.byte()
        if code == ord("#"):
            while code not in (10, 13):
                code = self.byte()
            return None
        ident = bytearray()
        while len(ident) < 8 and code not in _SPACE:
            ident.append(code)
            code = self.byte()
        if code not in _SPACE or bytes(ident) not in _FIELDS:
            self.fail(f"a PAM header line {bytes(ident)!r}; cv2 reads {b', '.join(_FIELDS)!r}")
        if code in (10, 13):
            return bytes(ident), b""
        while code in _SPACE:
            code = self.byte()
        value = bytearray()
        while len(value) < 255 and code not in (10, 13):
            value.append(code)
            code = self.byte()
        if code not in (10, 13):
            self.fail(f"a PAM {bytes(ident)!r} value of more than 255 bytes")
        return bytes(ident), bytes(value).rstrip(_SPACE)

    def number(self, ident: bytes, value: bytes) -> int:
        """cv2's ParseInt: digits, a leading '-' allowed, below 2³¹ − 1 in
        magnitude; an empty value is 0."""
        if not re.fullmatch(rb"(-?[0-9]+)?", value) or (value and abs(int(value)) >= 0x7FFFFFFF):
            self.fail(f"a PAM {ident.decode()} of {value!r}, not a number")
        return int(value or 0)


def decode_pam(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 (H, W, depth), RGB(A) order for depth 3 and 4; `name` labels
    the errors."""
    if not is_pam(blob):
        raise ValueError(f"{name}: not a PAM (P7) file")
    r = _Header(blob, name)
    if blob[2] not in (10, 13):
        r.fail("a PAM whose P7 is not followed by a newline")
    fields, tuple_type = {}, b""
    while True:
        got = r.line()
        if got is None:
            continue
        ident, value = got
        if ident == b"ENDHDR":
            break
        if ident == b"TUPLTYPE":
            if value not in _TUPLES:
                r.fail(f"a PAM of TUPLTYPE {value.decode(errors='replace')!r}; cv2 reads "
                       + ", ".join(t.decode() for t in _TUPLES if t))
            tuple_type = value
            continue
        if ident in fields:
            r.fail(f"a PAM header with {ident.decode()} twice")
        fields[ident] = r.number(ident, value)
    missing = [f.decode() for f in _FIELDS[:4] if f not in fields]
    if missing:
        r.fail(f"a PAM header without {', '.join(missing)}")
    h, w, depth, maxval = (fields[f] for f in _FIELDS[:4])
    if maxval > 255:
        r.fail(f"a 16-bit PAM (maxval {maxval}); cv2 returns uint16 or nothing, which the JAX "
               "package's / 255 mishandles, so the port reads 8-bit PAMs only")
    want = _TUPLES[tuple_type]
    if want is None and depth not in (1, 3):
        r.fail(f"a PAM of depth {depth} without a TUPLTYPE, which cv2 refuses (it guesses "
               "depth 1 or 3 only)")
    if want is not None and depth != want:
        r.fail(f"a PAM of TUPLTYPE {tuple_type.decode()} and depth {depth}, which cv2 refuses")
    check_size(w, h, name, "a PAM")
    bits = maxval == 1
    if bits and depth not in (1, 3):
        r.fail(f"a PAM of maxval 1 and depth {depth}, which cv2 fails to read")
    size = w * h * depth
    if r.pos + size > len(blob):
        r.fail("a truncated PAM")
    data = np.frombuffer(blob, np.uint8, size, r.pos).reshape(h, w * depth)
    if bits:  # each row's first bytes as packed bits
        grey = np.unpackbits(data[:, :(w + 7) // 8], axis=1)[:, :w] * np.uint8(255)
        return np.repeat(grey[..., None], depth, axis=-1)
    img = data.reshape(h, w, depth)
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:depth]]) if depth >= 3 else img.copy()
