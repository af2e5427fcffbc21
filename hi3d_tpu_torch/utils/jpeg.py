"""JPEG decoder without cv2 or PIL (counterpart of the JAX package's JPEG
reads through cv2: hi3d_tpu/utils/image.py:32-42 `load_image_rgb`,
hi3d_tpu/data/video_dataset.py:60-66 tar members, and the serve CLI's
`*.jpg`/`*.jpeg` glob, hi3d_tpu/pipelines/serve.py:446).

`decode_jpeg` gives what `cv2.imdecode(..., cv2.IMREAD_UNCHANGED)` gives
with OpenCV's libjpeg-turbo, bit for bit, as RGB: (H, W, 3) uint8 for a
colour image and (H, W, 1) for a grey one. Like cv2 under
IMREAD_UNCHANGED it applies no EXIF orientation. Scope: baseline and
extended sequential Huffman JPEGs of 8-bit samples (SOF0, SOF1), one or
three components, chroma at 4:4:4, 4:2:2 or 4:2:0, interleaved or not,
restart intervals, any size. A progressive, lossless, hierarchical or
arithmetic-coded file, 12-bit samples, CMYK/YCCK (four components) and
other chroma sampling raise a ValueError that names the format.

The decode in four steps, as libjpeg-turbo's decompressor runs it:
1. entropy decoding of each scan into quantised coefficients, in C
   (`csrc/jpeg_decode.c`, built at first use by `utils.cbuild`);
2. dequantisation and the integer ISLOW inverse DCT (jidctint.c), the
   output saturated to [0, 255] as libjpeg-turbo's SIMD IDCT saturates it;
3. "fancy" (triangle) chroma upsampling, h2v1 and h2v2 (jdsample.c), and
   the plain replication libjpeg uses for chroma 2 samples wide or less;
4. the fixed-point YCbCr→RGB of jdcolor.c.
Steps 2–4 are the functions below, in torch int32; the stage-2
degradation's JPEG round trip (data/degradation.py) runs the same
functions on the device after its forward DCT and quantisation.
"""

from __future__ import annotations

import ctypes
import functools
import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import cbuild

SIGNATURE = b"\xff\xd8\xff"

# ------------------------------------------------- libjpeg's integer math

def fix(x: float) -> int:
    """libjpeg's FIX(x): x in 16.16 fixed point."""
    return int(x * 65536 + 0.5)


def descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def idct_1d(c, final: bool):
    """One pass of libjpeg's jpeg_idct_islow over 8 int32 tensors (its
    all-zero-AC shortcuts give the same values)."""
    z1 = (c[2] + c[6]) * 4433
    tmp2 = z1 - c[6] * 15137
    tmp3 = z1 + c[2] * 6270
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * 9633
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    tmp0 = tmp0 * 2446 + z1 + z3
    tmp1 = tmp1 * 16819 + z2 + z4
    tmp2 = tmp2 * 25172 + z2 + z3
    tmp3 = tmp3 * 12299 + z1 + z4
    sh = 18 if final else 11  # CONST_BITS + PASS1_BITS + 3, CONST_BITS - PASS1_BITS
    return [descale(a, sh) for a in (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                                     tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def blocks(plane: torch.Tensor) -> torch.Tensor:
    """(T, 8·hb, 8·wb) → (T, hb, wb, 8, 8)."""
    t, h, w = plane.shape
    return plane.reshape(t, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)


def unblocks(b: torch.Tensor) -> torch.Tensor:
    t, hb, wb = b.shape[:3]
    return b.permute(0, 1, 3, 2, 4).reshape(t, hb * 8, wb * 8)


def transform_2d(x: torch.Tensor, fn, rows_first: bool) -> torch.Tensor:
    """Apply an 8-point 1-D pass along the rows (last axis) and then the
    columns of (..., 8, 8) blocks, or columns first."""
    def rows(v, final):
        return torch.stack(fn(list(v.unbind(-1)), final), dim=-1)

    def cols(v, final):
        return torch.stack(fn(list(v.unbind(-2)), final), dim=-2)

    if rows_first:
        return cols(rows(x, False), True)
    return rows(cols(x, False), True)


def dequantize_idct(coef: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """Quantised coefficients (T, hb, wb, 8, 8) int32 in natural order and
    their tables `qt` (T, 8, 8) → the decoder's samples (T, 8·hb, 8·wb) in
    [0, 255]: dequantisation, ISLOW inverse DCT (columns, then rows), the
    level shift, saturated."""
    out = transform_2d(coef * qt[:, None, None], idct_1d, rows_first=False)
    return unblocks((out + 128).clamp(0, 255))


def upsample_h2v1(p: torch.Tensor, w: int) -> torch.Tensor:
    """h2v1_fancy_upsample of (T, H, wc) chroma to (T, H, w): 3/4 of the
    nearer sample + 1/4 of the further one, rounding bias 1 then 2, edges
    replicated; plain doubling when the chroma is 2 samples wide or less."""
    t, h, wc = p.shape
    if wc <= 2:
        return p.repeat_interleave(2, dim=-1)[..., :w]
    left = torch.cat([p[..., :1], p[..., :-1]], dim=-1)
    right = torch.cat([p[..., 1:], p[..., -1:]], dim=-1)
    out = torch.stack([(3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2], dim=-1)
    return out.reshape(t, h, 2 * wc)[..., :w]


def upsample_h2v2(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """h2v2_fancy_upsample of (T, hc, wc) chroma to (T, h, w): 3/4 nearer
    + 1/4 further sample along each axis, edges replicated, the 8/7
    rounding bias alternating; plain doubling when the chroma is 2 samples
    wide or less."""
    t, hc, wc = p.shape
    if wc <= 2:
        return p.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)[:, :h, :w]
    above = torch.cat([p[:, :1], p[:, :-1]], dim=1)
    below = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
    s = torch.stack([3 * p + above, 3 * p + below], dim=2).reshape(t, 2 * hc, wc)
    left = torch.cat([s[..., :1], s[..., :-1]], dim=-1)
    right = torch.cat([s[..., 1:], s[..., -1:]], dim=-1)
    out = torch.stack([(3 * s + left + 8) >> 4, (3 * s + right + 7) >> 4], dim=-1)
    return out.reshape(t, 2 * hc, 2 * wc)[:, :h, :w]


@functools.lru_cache(maxsize=1)
def ycc_rgb_tables() -> Tuple[np.ndarray, ...]:
    """jdcolor.c build_ycc_rgb_table: Cr→R, Cb→B, Cr→G, Cb→G."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    tabs = ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)
    for t in tabs:
        t.setflags(write=False)
    return tabs


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c's ycc_rgb_convert of (T, H, W) samples → (T, 3, H, W) int
    in [0, 255]."""
    crr, cbb, crg, cbg = (torch.tensor(a, device=y.device) for a in ycc_rgb_tables())
    cb, cr = cb.long(), cr.long()
    rgb = torch.stack([y + crr[cr], y + ((cbg[cb] + crg[cr]) >> 16), y + cbb[cb]], dim=1)
    return rgb.clamp(0, 255)


# --------------------------------------------------------------- decoding

_SCAN_ERRORS = {-1: "a Huffman code that no table holds", -2: "a run past the 64th coefficient",
                -3: "a restart marker missing or out of sequence",
                -4: "an empty or malformed Huffman table",
                -5: "scan parameters out of range"}
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNSUPPORTED_SOF = {
    0xC2: "a progressive JPEG (SOF2)", 0xC3: "a lossless JPEG (SOF3)",
    0xC5: "a hierarchical JPEG (SOF5)", 0xC6: "a hierarchical progressive JPEG (SOF6)",
    0xC7: "a hierarchical lossless JPEG (SOF7)", 0xC9: "an arithmetic-coded JPEG (SOF9)",
    0xCA: "an arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "an arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "an arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "an arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "an arithmetic-coded hierarchical lossless JPEG (SOF15)"}
_MARKER = re.compile(b"\xff[^\x00\xff]")
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _native() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cbuild.load("jpeg_decode.c", "hi3d_jpeg", "decode_jpeg")
            lib.hi3d_jpeg_decode_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.hi3d_jpeg_decode_scan.restype = ctypes.c_int
            _lib = lib
    return _lib


class _Frame:
    """What the frame header and the tables say."""

    def __init__(self, name: str):
        self.name = name
        self.qt: Dict[int, np.ndarray] = {}
        self.bits = np.zeros((8, 17), np.uint8)
        self.vals = np.zeros((8, 256), np.uint8)
        self.restart = 0
        self.size: Optional[Tuple[int, int]] = None
        self.comps: List[Dict] = []
        self.adobe_transform: Optional[int] = None
        self.jfif = False

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def need(self, body: bytes, n: int, what: str):
        if len(body) < n:
            self.fail(f"a truncated {what}")


def _read_sof(fr: _Frame, body: bytes) -> None:
    if fr.size is not None:
        fr.fail("a second frame header")
    fr.need(body, 6, "frame header")
    precision, h, w, n = body[0], int.from_bytes(body[1:3], "big"), \
        int.from_bytes(body[3:5], "big"), body[5]
    if precision != 8:
        fr.fail(f"a {precision}-bit JPEG; only 8-bit samples decode")
    if h == 0:
        fr.fail("a JPEG whose height comes in a DNL marker; not supported")
    if w == 0:
        fr.fail("a JPEG of width 0")
    if n == 4:
        fr.fail("a CMYK/YCCK JPEG (4 components); not supported")
    if n not in (1, 3):
        fr.fail(f"a JPEG of {n} components; 1 (grey) or 3 (colour) decode")
    fr.need(body, 6 + 3 * n, "frame header")
    for i in range(n):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        c = {"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq}
        if any(d["id"] == cid for d in fr.comps):
            fr.fail(f"a frame that names component {cid} twice")
        if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
            fr.fail(f"component {cid} sampled {c['h']}x{c['v']}; factors 1 to 4 decode")
        if tq > 3:
            fr.fail(f"component {cid} with quantisation table {tq}; tables 0-3 decode")
        fr.comps.append(c)
    fr.size = (h, w)


def _layout(fr: _Frame) -> None:
    """Each component's coefficient array (whole MCUs) and sample size."""
    h, w = fr.size
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    if len(fr.comps) == 3:
        y, cb, cr = fr.comps
        ratio = (y["h"] // cb["h"], y["v"] // cb["v"])
        if (cb["h"], cb["v"]) != (cr["h"], cr["v"]) or ratio not in ((1, 1), (2, 1), (2, 2)) or \
                y["h"] % cb["h"] or y["v"] % cb["v"]:
            fr.fail("a JPEG with chroma sampling "
                    + ", ".join(f"{c['h']}x{c['v']}" for c in fr.comps)
                    + "; 4:4:4, 4:2:2 and 4:2:0 decode")
    fr.hmax, fr.vmax = hmax, vmax
    fr.mcus_x = -(-w // (8 * hmax))
    fr.mcus_y = -(-h // (8 * vmax))
    for c in fr.comps:
        c["width"] = -(-w * c["h"] // hmax)  # downsampled_width
        c["height"] = -(-h * c["v"] // vmax)
        c["coef"] = np.zeros((fr.mcus_y * c["v"], fr.mcus_x * c["h"], 64), np.int16)


def _scan(fr: _Frame, header: bytes, data: memoryview) -> int:
    """Decode one scan; returns the bytes of entropy-coded data read."""
    fr.need(header, 1, "scan header")
    n = header[0]
    if not 1 <= n <= len(fr.comps):
        fr.fail(f"a scan of {n} components in a frame of {len(fr.comps)}")
    fr.need(header, 4 + 2 * n, "scan header")
    ids = {c["id"]: c for c in fr.comps}
    members, desc = [], []
    for i in range(n):
        cid, tables = header[1 + 2 * i], header[2 + 2 * i]
        if cid not in ids:
            fr.fail(f"a scan of component {cid}, which the frame does not have")
        if any(c["id"] == cid for c in members):
            fr.fail(f"a scan that names component {cid} twice")
        if tables >> 4 > 3 or tables & 15 > 3:
            fr.fail(f"a scan of component {cid} with Huffman tables {tables >> 4} (DC) and "
                    f"{tables & 15} (AC); tables 0-3 decode")
        members.append(ids[cid])
        desc.append((tables >> 4, tables & 15))
    ss, se, a = header[1 + 2 * n], header[2 + 2 * n], header[3 + 2 * n]
    if (ss, se, a) != (0, 63, 0):
        fr.fail("a scan of a spectral selection or successive approximation; "
                "only sequential scans decode")
    if n == 1:
        c = members[0]
        mcus_x, mcus_y = -(-c["width"] // 8), -(-c["height"] // 8)
        rows = [(1, 1)]
    else:
        mcus_x, mcus_y = fr.mcus_x, fr.mcus_y
        rows = [(c["h"], c["v"]) for c in members]
        if sum(c["h"] * c["v"] for c in members) > 10:
            fr.fail("an interleaved scan of more than 10 blocks an MCU")
    table = np.array([(hv[0], hv[1], dc, ac, c["coef"].shape[1], c["coef"].shape[0])
                      for hv, (dc, ac), c in zip(rows, desc, members)], np.int32)
    ptrs = (ctypes.c_void_p * n)(*[c["coef"].ctypes.data for c in members])
    buf = np.frombuffer(data, np.uint8)
    end = ctypes.c_long(0)
    err = _native().hi3d_jpeg_decode_scan(
        buf.ctypes.data, buf.size, ctypes.byref(end), n, table.ctypes.data, ptrs,
        fr.bits.ctypes.data, fr.vals.ctypes.data, mcus_x, mcus_y, fr.restart)
    if err:
        fr.fail(f"corrupt JPEG data: {_SCAN_ERRORS.get(err, err)}")
    return end.value


def _components(fr: _Frame) -> List[torch.Tensor]:
    """Each component's samples (1, height, width) int32: dequantised,
    inverse-transformed and cropped to its size."""
    out = []
    for c in fr.comps:
        if c["tq"] not in fr.qt:
            fr.fail(f"no quantisation table {c['tq']}")
        coef = torch.from_numpy(c["coef"].astype(np.int32)).reshape(
            1, *c["coef"].shape[:2], 8, 8)
        qt = torch.from_numpy(fr.qt[c["tq"]].astype(np.int32)).reshape(1, 8, 8)
        out.append(dequantize_idct(coef, qt)[:, :c["height"], :c["width"]])
    return out


def decode_jpeg(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """uint8 (H, W, 3) RGB, or (H, W, 1) for a grey JPEG; `name` labels
    the errors."""
    fr = _Frame(name)
    if not blob.startswith(SIGNATURE):
        fr.fail("not a JPEG file")
    view = memoryview(blob)
    pos, scans = 2, 0
    while True:
        m = _MARKER.search(blob, pos)
        if m is None:
            break
        kind = blob[m.start() + 1]
        pos = m.start() + 2
        if kind == 0xD9:  # EOI
            break
        if 0xD0 <= kind <= 0xD7 or kind == 0x01:
            continue
        length = int.from_bytes(blob[pos:pos + 2], "big")
        if length < 2 or pos + length > len(blob):
            fr.fail(f"a truncated JPEG: its 0xFF{kind:02X} segment runs past the end")
        body = blob[pos + 2:pos + length]
        pos += length
        if kind in (0xC0, 0xC1):
            _read_sof(fr, body)
            _layout(fr)
        elif kind in _UNSUPPORTED_SOF:
            fr.fail(f"{_UNSUPPORTED_SOF[kind]}; only baseline and extended sequential "
                    "Huffman JPEGs decode")
        elif kind == 0xC4:  # DHT
            i = 0
            while i < len(body):
                fr.need(body[i:], 17, "Huffman table")
                tc, th = body[i] >> 4, body[i] & 15
                if tc > 1 or th > 3:
                    fr.fail(f"a Huffman table of class {tc} and id {th}; classes 0-1 "
                            "and ids 0-3 decode")
                counts = np.frombuffer(body[i + 1:i + 17], np.uint8)
                total = int(counts.sum())
                if total > 256:
                    fr.fail(f"a Huffman table of {total} codes (at most 256)")
                fr.need(body[i:], 17 + total, "Huffman table")
                k = 4 * tc + th
                fr.bits[k, 1:] = counts
                fr.vals[k, :total] = np.frombuffer(body[i + 17:i + 17 + total], np.uint8)
                i += 17 + total
        elif kind == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq > 1 or tq > 3:
                    fr.fail(f"a quantisation table of precision {pq} and id {tq}; "
                            "precisions 0-1 and ids 0-3 decode")
                size = 128 if pq else 64
                fr.need(body[i:], 1 + size, "quantisation table")
                raw = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = raw
                fr.qt[tq] = table
                i += 1 + size
        elif kind == 0xDD:  # DRI
            fr.need(body, 2, "restart interval")
            fr.restart = int.from_bytes(body[:2], "big")
        elif kind == 0xDA:  # SOS
            if fr.size is None:
                fr.fail("a scan before the frame header")
            pos += _scan(fr, body, view[pos:])
            scans += 1
        elif kind == 0xDC:
            fr.fail("a DNL marker; not supported")
        elif kind == 0xE0 and body[:5] == b"JFIF\x00":
            fr.jfif = True
        elif kind == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            fr.adobe_transform = body[11]
    if fr.size is None or not scans:
        fr.fail("a JPEG without a frame or a scan")
    h, w = fr.size
    planes = _components(fr)
    if len(planes) == 1:
        return planes[0][0].numpy().astype(np.uint8)[:, :, None]
    rgb_ids = [c["id"] for c in fr.comps] == [82, 71, 66]  # 'R', 'G', 'B'
    if fr.adobe_transform == 0 or (not fr.jfif and fr.adobe_transform is None and rgb_ids):
        fr.fail("an RGB-coded JPEG (no YCbCr transform); not supported")
    y, cb, cr = planes
    ratio = (fr.comps[0]["h"] // fr.comps[1]["h"], fr.comps[0]["v"] // fr.comps[1]["v"])
    if ratio == (2, 2):
        cb, cr = (upsample_h2v2(p, h, w) for p in (cb, cr))
    elif ratio == (2, 1):
        cb, cr = (upsample_h2v1(p, w) for p in (cb, cr))
    rgb = ycc_to_rgb(y, cb, cr)[0]
    return rgb.permute(1, 2, 0).numpy().astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of a file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def is_jpeg(blob: bytes) -> bool:
    return blob.startswith(SIGNATURE)

