"""What the raster decoders' tests (tests/test_torch_{bmp,tiff,gif,pnm}.py)
share: cv2's decode as the port's reference, the check of one file through
every reader with cv2 hidden, the committed fixtures and their goldens, the
damaged-file rule; and encoders for the file variants cv2 and PIL do not
write, built here from numpy arrays. BMP (every header, depth, compression
and row order), TIFF (strips or tiles, both planar configurations,
FillOrder 2, both byte orders, LZW in libtiff's and the old LSB-first form,
PackBits, Deflate, JPEG strips with or without JPEGTables, the predictor),
GIF (global and local tables, interlace, transparency, a frame smaller than
the screen) and Sun raster (colormaps, depths, types)."""

import hashlib
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import cv2

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)  # damaged files by the hundred
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(1, 1), (2, 3), (5, 4), (7, 9), (17, 23), (31, 30), (100, 77), (389, 517)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: the JPEG strips of TIFFs decode in
    torch on the CPU (utils/jpeg.py), whose many small ops run up to 6×
    slower on this machine's 8 threads; xdist workers get one anyway."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cv2_rgb(blob: bytes):
    """cv2's IMREAD_UNCHANGED decode as the port gives it: (H, W, C) RGB(A),
    or None where cv2 fails."""
    if not blob:
        return None
    try:
        img = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    except cv2.error:  # past its size limits
        return None
    if img is None:
        return None
    if img.ndim == 2:
        return img[..., None]
    if img.shape[-1] == 2:  # grey and alpha
        return img
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[-1]]])


def golden(img: np.ndarray) -> dict:
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def demo(h: int, w: int, seed: int = 0) -> np.ndarray:
    """demo/3.png as RGB at (h, w) with a little seeded noise."""
    img = cv2.imread(os.path.join(ROOT, "demo", "3.png"), cv2.IMREAD_COLOR)
    if (h, w) != img.shape[:2]:
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    noise = np.random.RandomState(seed).randint(-12, 13, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)[..., ::-1].copy()


def hide_cv2(monkeypatch) -> None:
    """Within the test, utils.image finds no cv2 to hand a file to."""
    from hi3d_tpu_torch.utils import image

    monkeypatch.setattr(image, "_cv2", lambda: None)


def same_as_cv2(blob: bytes, decode, label: str = "", path: str = None) -> np.ndarray:
    """`utils.image.decode_image(blob)` equals cv2's decode; with `path`,
    `decode(blob)` too and the file written there through `read_image`, and
    `load_image_rgb` equal to the JAX package's (cv2's). Run with cv2
    hidden (`hide_cv2`) to hold the port's own decoders."""
    from hi3d_tpu.utils.image import load_image_rgb as jax_load_image_rgb
    from hi3d_tpu_torch.utils import image

    want = cv2_rgb(blob)
    assert want is not None, label
    for got in [image.decode_image(blob, label)] + ([decode(blob, label)] if path else []):
        assert got.dtype == np.uint8 and got.shape == want.shape, (label, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=label)
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
        np.testing.assert_array_equal(image.read_image(path), want, err_msg=label)
        np.testing.assert_array_equal(image.load_image_rgb(path), jax_load_image_rgb(path),
                                      err_msg=label)
    return want


def write_fixtures(folder: str, fixtures: dict) -> None:
    """Each fixture's file and its cv2 golden in folder/goldens.json."""
    os.makedirs(folder, exist_ok=True)
    goldens = {}
    for name, make in fixtures.items():
        blob = make()
        with open(os.path.join(folder, name), "wb") as f:
            f.write(blob)
        goldens[name] = golden(cv2_rgb(blob))
    with open(os.path.join(folder, "goldens.json"), "w") as f:
        json.dump(goldens, f, indent=1, sort_keys=True)


def check_fixtures(folder: str, fixtures: dict, read) -> int:
    """Every committed fixture decodes (`read`, a path reader) to its
    golden, as cv2 does; returns the folder's bytes."""
    with open(os.path.join(folder, "goldens.json")) as f:
        goldens = json.load(f)
    assert set(goldens) == set(fixtures)
    total = 0
    for name, want in goldens.items():
        path = os.path.join(folder, name)
        total += os.path.getsize(path)
        with open(path, "rb") as f:
            assert golden(cv2_rgb(f.read())) == want, name
        assert golden(read(path)) == want, name
    return total


def holds(case: bytes, decode, counts: dict) -> None:
    """The damaged-file rule on one file: `decode` raises a ValueError
    (naming the file) or gives cv2's pixels; the outcome is counted."""
    want = cv2_rgb(case)
    try:
        got = decode(case, "bad")
    except ValueError as e:
        assert str(e).startswith("bad: "), e
        counts["raised"] += 1
        counts["cv2_failed_too"] += want is None
        return
    assert want is not None, "decoded a file cv2 fails on"
    np.testing.assert_array_equal(got, want)
    counts["as_cv2"] += 1


def damaged(blob: bytes, decode, seed: int, flips: int = 150) -> dict:
    """`holds` on about 60 truncations and `flips` seeded byte flips of
    `blob`; returns the count of each outcome."""
    counts = {"raised": 0, "as_cv2": 0, "cv2_failed_too": 0}
    rnd = np.random.RandomState(seed)
    for cut in range(0, len(blob), max(1, len(blob) // 60)):
        holds(blob[:cut], decode, counts)
    for _ in range(flips):
        bad = bytearray(blob)
        for _ in range(rnd.randint(1, 4)):
            bad[rnd.randint(len(bad))] = rnd.randint(256)
        holds(bytes(bad), decode, counts)
    return counts


# ----------------------------------------------------------------- LZW


class _Bits:
    def __init__(self, lsb: bool):
        self.lsb, self.acc, self.n, self.out = lsb, 0, 0, bytearray()

    def put(self, code: int, width: int):
        if self.lsb:
            self.acc |= code << self.n
            self.n += width
            while self.n >= 8:
                self.out.append(self.acc & 255)
                self.acc >>= 8
                self.n -= 8
        else:
            self.acc = (self.acc << width) | code
            self.n += width
            while self.n >= 8:
                self.out.append((self.acc >> (self.n - 8)) & 255)
                self.n -= 8
            self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 255 if not self.lsb else self.acc & 255)
        return bytes(self.out)


def lzw(data: bytes, min_code_size: int = 8, style: str = "tiff", clear_at: int = 4093) -> bytes:
    """LZW of `data`: style "tiff" (MSB-first, early change), "compat"
    (libtiff's old LSB-first form) or "gif" (LSB-first, min_code_size).
    A clear code goes out whenever the table reaches `clear_at` entries;
    with `clear_at` None never (a "deferred clear": the full table is kept)."""
    lsb = style != "tiff"
    early = 1 if style == "tiff" else 0
    mcs = min_code_size if style == "gif" else 8
    clear, end = 1 << mcs, (1 << mcs) + 1
    bits = _Bits(lsb)
    width = mcs + 1

    def reset():
        return {bytes([i]): i for i in range(1 << mcs)}, end + 1

    table, nxt = reset()
    dnext, first = end + 1, True  # the decoder's next entry; its first code adds none
    bits.put(clear, width)

    def sent():
        nonlocal dnext, width, first
        if first:
            first = False
            return
        dnext += 1
        if dnext >= (1 << width) - early and width < 12:
            width += 1

    s = b""
    for c in data:
        sc = s + bytes([c])
        if sc in table:
            s = sc
            continue
        bits.put(table[s], width)
        sent()
        if nxt < 4096:  # a full table takes no more entries (clear_at None: no clear code)
            table[sc] = nxt
            nxt += 1
        s = bytes([c])
        if clear_at is not None and nxt >= clear_at:
            bits.put(clear, width)
            table, nxt = reset()
            width, dnext, first = mcs + 1, end + 1, True
    if s:
        bits.put(table[s], width)
        sent()
    bits.put(end, width)
    return bits.flush()


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, literals of up to 128."""
    out, i, lit = bytearray(), 0, bytearray()

    def flush_lit():
        while lit:
            chunk = lit[:128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
            del lit[:128]

    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 128:
            j += 1
        if j - i >= 2:
            flush_lit()
            out.append(257 - (j - i))
            out.append(data[i])
            i = j
        else:
            lit.append(data[i])
            i += 1
    flush_lit()
    return bytes(out)


# ----------------------------------------------------------------- TIFF

_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _pack(samples: np.ndarray, bits: int) -> bytes:
    """(rows, cols·spp) uint8 samples → rows packed at `bits`, MSB first,
    each row padded to a byte."""
    if bits == 8:
        return samples.astype(np.uint8).tobytes()
    per = 8 // bits
    rows, cols = samples.shape
    pad = -cols % per
    s = np.concatenate([samples, np.zeros((rows, pad), samples.dtype)], 1).astype(np.uint8)
    s = s.reshape(rows, -1, per)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return (s << shifts).sum(-1).astype(np.uint8).tobytes()


def _predict(rows: np.ndarray, stride: int) -> np.ndarray:
    out = rows.astype(np.int16).copy()
    out[:, stride:] -= rows[:, :-stride].astype(np.int16)
    return (out & 255).astype(np.uint8)


def _jpeg_chunk(chunk: np.ndarray, sampling: str, tables: bool):
    """One strip or tile as a JPEG: YCbCr through cv2 (sampling "420",
    "422", "444"); returns (stream, JPEGTables or None)."""
    factor = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
              "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
              "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sampling]
    img = chunk[..., ::-1] if chunk.shape[-1] == 3 else chunk[..., 0]
    blob = cv2.imencode(".jpg", np.ascontiguousarray(img),
                        [cv2.IMWRITE_JPEG_QUALITY, 80,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])[1].tobytes()
    if not tables:
        return blob, None
    head, body, pos = [], [], 2
    while True:
        kind, length = blob[pos + 1], int.from_bytes(blob[pos + 2:pos + 4], "big")
        seg = blob[pos:pos + 2 + length]
        if kind == 0xDA:
            body.append(blob[pos:])
            break
        (head if kind in (0xDB, 0xC4) else body).append(seg)
        pos += 2 + length
    return b"\xff\xd8" + b"".join(body), b"\xff\xd8" + b"".join(head) + b"\xff\xd9"


def tiff(img: np.ndarray, photometric: int, bits: int = 8, compression: int = 1,
         predictor: int = 1, rows_per_strip=None, tile=None, planar: int = 1,
         fill_order: int = 1, extra_samples=None, colormap=None, big_endian: bool = False,
         lzw_style: str = "tiff", sampling: str = "420", jpeg_tables: bool = True,
         extra_tags=None) -> bytes:
    """A TIFF of `img` (h, w, spp) uint8 samples as stored (for
    photometric 6 under JPEG: RGB, encoded as YCbCr at quality 80), one
    IFD."""
    e = ">" if big_endian else "<"
    img = img if img.ndim == 3 else img[..., None]
    h, w, spp = img.shape
    chunks = []
    if tile:
        tw, th = tile
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
        cw, chh = tw, th
    else:
        rps = rows_per_strip or h
        grid = [(y, 0) for y in range(0, h, rps)]
        cw, chh = w, rps
    planes = range(spp) if planar == 2 else [None]
    tables = None
    for p in planes:
        for y, x in grid:
            part = img[y:y + chh, x:x + cw] if p is None else img[y:y + chh, x:x + cw, p:p + 1]
            rows = part.shape[0] if not tile else chh
            full = np.zeros((rows, cw, part.shape[-1]), np.uint8)
            full[:part.shape[0], :part.shape[1]] = part
            if compression == 7:
                raw, tables = _jpeg_chunk(full if tile else full[:part.shape[0]], sampling,
                                          jpeg_tables)
            else:
                flat = full.reshape(rows, -1)
                if predictor == 2:
                    flat = _predict(flat, full.shape[-1])
                data = _pack(flat, bits)
                raw = {5: lambda d: lzw(d, style=lzw_style), 8: zlib.compress,
                       32946: zlib.compress, 32773: packbits}.get(compression, bytes)(data)
                if fill_order == 2:
                    raw = _REV[np.frombuffer(raw, np.uint8)].tobytes()
            chunks.append(raw)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if tile:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
    elif rows_per_strip:
        entries[278] = (4, [rows_per_strip])
    if extra_samples is not None:
        entries[338] = (3, list(extra_samples))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap, np.int64).T.ravel()))
    if tables is not None:
        entries[347] = (7, tables)
    if photometric == 6:
        entries[530] = (3, {"420": [2, 2], "422": [2, 1], "444": [1, 1]}[sampling])
    entries.update(extra_tags or {})
    body = bytearray(b"MM\x00*" if big_endian else b"II*\x00") + b"\0\0\0\0"
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
        if len(body) & 1:
            body += b"\0"
    ent = dict(entries)
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    ent[off_tag] = (4, offsets)
    ent[cnt_tag] = (4, [len(c) for c in chunks])
    ifd = len(body)
    extra = bytearray()
    base = ifd + 2 + 12 * len(ent) + 4
    recs = []
    for tag in sorted(ent):
        kind, vals = ent[tag]
        if kind == 7:
            payload = bytes(vals)
            count = len(payload)
        else:
            fmt = {3: "H", 4: "I"}[kind]
            payload = struct.pack(f"{e}{len(vals)}{fmt}", *[int(v) for v in vals])
            count = len(vals)
        if len(payload) <= 4:
            recs.append(struct.pack(f"{e}HHI", tag, kind, count) + payload.ljust(4, b"\0"))
        else:
            recs.append(struct.pack(f"{e}HHII", tag, kind, count, base + len(extra)))
            extra += payload
            if len(extra) & 1:
                extra += b"\0"
    body += struct.pack(f"{e}H", len(recs)) + b"".join(recs) + b"\0\0\0\0" + extra
    struct.pack_into(f"{e}I", body, 4, ifd)
    return bytes(body)


# ------------------------------------------------------------------ BMP

def bmp(idx_or_px: np.ndarray, bits: int, compression: int = 0, header: int = 40,
        palette=None, masks=None, top_down: bool = False, header_masks=None,
        rle: bytes = None) -> bytes:
    """A BMP: `idx_or_px` (h, w) palette indices for bits <= 8, (h, w)
    uint16 words for 16 bits, (h, w, 3|4) BGR(A) bytes for 24/32; rows
    written bottom-up unless `top_down`; `rle` replaces the pixel data."""
    h, w = idx_or_px.shape[:2]
    pitch = ((w * bits + 31) // 32) * 4
    rows = idx_or_px[::-1] if not top_down else idx_or_px
    if rle is not None:
        data = rle
    else:
        if bits <= 8:
            raw = _pack(rows.reshape(h, w).astype(np.uint8), bits)
            per_row = (w * bits + 7) // 8
            raw = np.frombuffer(raw, np.uint8).reshape(h, per_row)
        elif bits == 16:
            raw = rows.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        else:
            raw = rows.reshape(h, -1)
        data = np.zeros((h, pitch), np.uint8)
        data[:, :raw.shape[1]] = raw
        data = data.tobytes()
    if header == 12:
        ih = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        n = 0 if palette is None else len(palette)
        ih = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression,
                         len(data), 2835, 2835, n, 0)
        if header > 40:
            ih += struct.pack("<IIII", *(header_masks or (0, 0, 0, 0)))[:header - 40]
            ih = ih.ljust(header, b"\0")
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)
        pal = b"".join(bytes([c[2], c[1], c[0]] + ([0] if header != 12 else [])) for c in p)
    mk = b"" if masks is None else struct.pack(f"<{len(masks)}I", *masks)
    off = 14 + len(ih) + len(mk) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + ih + mk + pal + data


def bmp_rle(idx: np.ndarray, bits: int, seed: int = 0) -> bytes:
    """A valid BI_RLE8/BI_RLE4 stream of (h, w) indices (top row first in
    `idx`; rows written bottom-up) that mixes encoded runs, absolute runs
    and end-of-line escapes, with a delta over a zero-index stretch where
    one is found, and an end of bitmap."""
    rnd = np.random.RandomState(seed)
    h, w = idx.shape
    out = bytearray()
    rows = idx[::-1]
    y = 0
    while y < h:
        row = rows[y]
        x = 0
        while x < w:
            # a delta over zeros running to the next rows' start
            j = x
            while j < w and row[j] == 0:
                j += 1
            if j - x >= 3 and rnd.rand() < 0.5 and j < w:
                out += bytes([0, 2, j - x, 0])
                x = j
                continue
            n = 1
            cap = min(255, w - x)
            if bits == 8:
                while n < cap and row[x + n] == row[x]:
                    n += 1
                if n >= 2 or cap < 3 or rnd.rand() < 0.3:
                    out += bytes([n, row[x]])
                    x += n
                    continue
            else:
                while n < cap and row[x + n] == row[x + (n & 1)]:
                    n += 1
                if n >= 2 or cap < 3 or rnd.rand() < 0.3:
                    hi = row[x]
                    lo = row[x + 1] if n > 1 else 0
                    out += bytes([n, hi << 4 | lo])
                    x += n
                    continue
            k = min(cap, rnd.randint(3, 40))
            lit = row[x:x + k]
            out += bytes([0, k])
            if bits == 8:
                out += bytes(lit) + (b"\0" if k & 1 else b"")
            else:
                packed = _pack(lit[None].astype(np.uint8), 4)
                out += packed + (b"\0" if len(packed) & 1 else b"")
            x += k
        y += 1
        out += bytes([0, 1]) if y == h else bytes([0, 0])
    return bytes(out)


# ------------------------------------------------------------------ GIF

def gif(screen, frames, gct=None, bg: int = 0, version: bytes = b"89a") -> bytes:
    """A GIF: `screen` (w, h); `frames` a list of dicts with idx (h, w),
    left, top, and optional lct, interlace, transparent (index), min_code_size,
    clear_at. Palettes are (n, 3) RGB with n a power of two."""
    def table_flags(p):
        return (len(p) - 1).bit_length() - 1

    out = bytearray(b"GIF" + version + struct.pack("<HH", *screen))
    flags = 0 if gct is None else 0x80 | 0x70 | table_flags(gct)
    out += bytes([flags, bg, 0])
    if gct is not None:
        out += np.asarray(gct, np.uint8).tobytes()
    for f in frames:
        if "transparent" in f:
            out += b"\x21\xf9\x04" + bytes([1]) + b"\0\0" + bytes([f["transparent"]]) + b"\0"
        idx = f["idx"]
        h, w = idx.shape
        iflags = 0
        if f.get("lct") is not None:
            iflags |= 0x80 | table_flags(f["lct"])
        if f.get("interlace"):
            iflags |= 0x40
            order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                    np.arange(2, h, 4), np.arange(1, h, 2)])
            idx = idx[order]
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), w, h, iflags)
        if f.get("lct") is not None:
            out += np.asarray(f["lct"], np.uint8).tobytes()
        mcs = f.get("min_code_size", 8)
        data = lzw(idx.astype(np.uint8).tobytes(), mcs, "gif", f.get("clear_at", 4095))
        out += bytes([mcs])
        for i in range(0, len(data), 255):
            part = data[i:i + 255]
            out += bytes([len(part)]) + part
        out += b"\0"
    return bytes(out + b";")


# ----------------------------------------------------------- Sun raster

def sunras(img: np.ndarray, depth: int, kind: int = 1, cmap=None) -> bytes:
    """A Sun raster: (h, w) indices for depth 1 and 8, (h, w, 3|4) bytes as
    stored for 24 and 32; rows padded to 16 bits; `cmap` (3, n) R, G, B."""
    h, w = img.shape[:2]
    if depth <= 8:
        rows = np.frombuffer(_pack(img.reshape(h, w).astype(np.uint8), depth), np.uint8)
        rows = rows.reshape(h, -1)
    else:
        rows = img.reshape(h, -1)
    pitch = (rows.shape[1] + 1) & ~1
    data = np.zeros((h, pitch), np.uint8)
    data[:, :rows.shape[1]] = rows
    cm = b"" if cmap is None else np.asarray(cmap, np.uint8).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, data.size, kind, 1 if cm else 0,
                       len(cm)) + cm + data.tobytes()
