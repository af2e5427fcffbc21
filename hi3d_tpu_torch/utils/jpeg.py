"""JPEG decoder without cv2 or PIL (counterpart of the JAX package's JPEG
reads through cv2: hi3d_tpu/utils/image.py:32-42 `load_image_rgb`,
hi3d_tpu/data/video_dataset.py:60-66 tar members, and the serve CLI's
`*.jpg`/`*.jpeg` glob, hi3d_tpu/pipelines/serve.py:446).

`decode_jpeg` gives what `cv2.imdecode(..., cv2.IMREAD_UNCHANGED)` gives
with OpenCV's libjpeg-turbo, bit for bit, as RGB: (H, W, 3) uint8 for a
colour image and (H, W, 1) for a grey one. Like cv2 under
IMREAD_UNCHANGED it applies no EXIF orientation. Scope: baseline, extended
sequential and progressive Huffman JPEGs of 8-bit samples (SOF0, SOF1,
SOF2), grey, YCbCr, RGB-coded (an Adobe marker with transform 0, or the
component ids 'R', 'G', 'B' without JFIF) and CMYK (four components,
returned as cv2's own CMYK→BGR conversion gives them, in RGB order); every
integral sampling ratio from 1 to 4, interleaved or not, restart intervals,
any size. A lossless, hierarchical or arithmetic-coded file, 12-bit
samples, YCCK (Adobe transform 2) and fractional sampling ratios raise a
ValueError that names the format.

The decode in four steps, as libjpeg-turbo's decompressor runs it:
1. entropy decoding of each scan into quantised coefficients, in C
   (`csrc/jpeg_decode.c`, built at first use by `utils.cbuild`); the scans
   of a progressive file add up in the same coefficient arrays, and one
   that ends with coefficients unrefined (`_needs_smoothing`, a file cut
   before its last refinement) is block-smoothed as jdcoefct.c's
   decompress_smooth_data smooths it (`hi3d_jpeg_smooth` in C);
2. dequantisation and the integer ISLOW inverse DCT (jidctint.c), the
   output saturated to [0, 255] as libjpeg-turbo's SIMD IDCT saturates it
   (and its 16-bit lanes for coefficients of damaged data);
3. chroma upsampling as jdsample.c chooses it for each component: "fancy"
   (triangle) h2v1, h1v2 and h2v2, plain replication for h2v1 and h2v2
   chroma 2 samples wide or less and for every other integral ratio;
4. the fixed-point YCbCr→RGB of jdcolor.c (none for RGB; cv2's
   `icvCvt_CMYK2BGR_8u_C4C3R` for CMYK).
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
from .raster import Unsupported

SIGNATURE = b"\xff\xd8\xff"

# ------------------------------------------------- libjpeg's integer math

def fix(x: float) -> int:
    """libjpeg's FIX(x): x in 16.16 fixed point."""
    return int(x * 65536 + 0.5)


def descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def idct_1d(c, final: bool):
    """One pass of libjpeg's jpeg_idct_islow over 8 int32 tensors (its
    all-zero-AC shortcuts give the same values), with the four sums that
    libjpeg-turbo's SIMD version forms in 16-bit lanes (in0 ± in4, in7 +
    in3, in5 + in1) wrapped as there: the same values for the coefficients
    of valid data."""
    z1 = (c[2] + c[6]) * 4433
    tmp2 = z1 - c[6] * 15137
    tmp3 = z1 + c[2] * 6270
    tmp0 = _wrap16(c[0] + c[4]) << 13
    tmp1 = _wrap16(c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, _wrap16(tmp0 + tmp2), _wrap16(tmp1 + tmp3)
    z5 = (z3 + z4) * 9633
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    tmp0 = tmp0 * 2446 + z1 + z3
    tmp1 = tmp1 * 16819 + z2 + z4
    tmp2 = tmp2 * 25172 + z2 + z3
    tmp3 = tmp3 * 12299 + z1 + z4
    sh = 18 if final else 11  # CONST_BITS + PASS1_BITS + 3, CONST_BITS - PASS1_BITS
    return [descale(a, sh) for a in (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                                     tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    return ((x + 32768) & 0xFFFF) - 32768


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
    level shift, saturated. The 16-bit lanes of libjpeg-turbo's SIMD IDCT,
    which only coefficients past the range of valid data reach, come
    along: the products wrap, the column pass saturates, and a block whose
    rows 1–7 are zero takes its DC column shortcut (shifted, wrapping)."""
    dq = _wrap16(coef * qt[:, None, None])
    cols = torch.stack(idct_1d(list(dq.unbind(-2)), False), dim=-2).clamp(-32768, 32767)
    dc_only = (coef[..., 1:, :] == 0).all(-1).all(-1)[..., None, None]
    cols = torch.where(dc_only, _wrap16(dq[..., :1, :] << 2), cols)
    out = torch.stack(idct_1d(list(cols.unbind(-1)), True), dim=-1)
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


def upsample_h1v2(p: torch.Tensor, h: int) -> torch.Tensor:
    """h1v2_fancy_upsample of (T, hc, W) chroma to (T, h, W): 3/4 of the
    nearer row + 1/4 of the further one, rounding bias 1 (upper) then 2,
    edge rows replicated."""
    t, hc, w = p.shape
    above = torch.cat([p[:, :1], p[:, :-1]], dim=1)
    below = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
    out = torch.stack([(3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2], dim=2)
    return out.reshape(t, 2 * hc, w)[:, :h]


def upsample(p: torch.Tensor, ratio: Tuple[int, int], h: int, w: int) -> torch.Tensor:
    """A component's (T, hc, wc) samples at `ratio` (across, down) below the
    image's (T, h, w), upsampled as jdsample.c's jinit_upsampler picks the
    method: fancy h2v1, h1v2 and h2v2, plain replication (h2v1_upsample,
    h2v2_upsample, int_upsample) otherwise."""
    if ratio == (1, 1):
        return p
    if ratio == (2, 1) and p.shape[-1] > 2:
        return upsample_h2v1(p, w)
    if ratio == (1, 2):
        return upsample_h1v2(p, h)
    if ratio == (2, 2) and p.shape[-1] > 2:
        return upsample_h2v2(p, h, w)
    return p.repeat_interleave(ratio[1], dim=-2).repeat_interleave(ratio[0], dim=-1)[:, :h, :w]


def cmyk_to_rgb(c, m, y, k) -> torch.Tensor:
    """cv2's icvCvt_CMYK2BGR_8u_C4C3R on libjpeg's CMYK samples (T, H, W)
    → (T, 3, H, W): each ink x becomes k - ((255 - x)·k >> 8); the BGR it
    writes, in RGB order."""
    return torch.stack([k - (((255 - x) * k) >> 8) for x in (c, m, y)], dim=1)


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

_SCAN_ERRORS = {-4: "an empty or malformed Huffman table", -5: "scan parameters out of range"}
_SCAN_KINDS = {(False, False): "DC first", (False, True): "DC refinement",
               (True, False): "AC first", (True, True): "AC refinement"}
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNSUPPORTED_SOF = {
    0xC3: "a lossless JPEG (SOF3)",
    0xC5: "a hierarchical JPEG (SOF5)", 0xC6: "a hierarchical progressive JPEG (SOF6)",
    0xC7: "a hierarchical lossless JPEG (SOF7)", 0xC9: "an arithmetic-coded JPEG (SOF9)",
    0xCA: "an arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "an arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "an arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "an arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "an arithmetic-coded hierarchical lossless JPEG (SOF15)"}
_MARKER = re.compile(b"\xff[^\x00\xff]")
_FILE_END = b"\xff\xd9" * 32768  # more than the longest segment
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _native() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cbuild.load("jpeg_decode.c", "hi3d_jpeg", "decode_jpeg")
            lib.hi3d_jpeg_decode_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.hi3d_jpeg_decode_scan.restype = ctypes.c_int
            lib.hi3d_jpeg_decode_progressive.argtypes = \
                lib.hi3d_jpeg_decode_scan.argtypes + [ctypes.c_int] * 4
            lib.hi3d_jpeg_decode_progressive.restype = ctypes.c_int
            lib.hi3d_jpeg_smooth.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p] * 3 + [ctypes.c_long]
            lib.hi3d_jpeg_smooth.restype = ctypes.c_int
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
        self.progressive = False
        self.scans = 0  # libjpeg's input_scan_number
        self.last_good = 0  # the last iMCU row the last scan decoded from data

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def unsupported(self, what: str):
        raise Unsupported(f"{self.name}: {what}")

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
        fr.unsupported(f"a {precision}-bit JPEG; only 8-bit samples decode")
    if h == 0:
        fr.unsupported("a JPEG whose height comes in a DNL marker; not supported")
    if w == 0:
        fr.fail("a JPEG of width 0")
    if n not in (1, 3, 4):
        fr.fail(f"a JPEG of {n} components; 1 (grey), 3 (colour) or 4 (CMYK) decode")
    if len(body) != 6 + 3 * n:
        fr.fail(f"a frame header of {len(body)} bytes for {n} components")
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
    """Each component's coefficient array (whole MCUs), sample size and
    upsampling ratio; a ratio that is not whole raises, as libjpeg's
    JERR_FRACT_SAMPLE_NOTIMPL."""
    h, w = fr.size
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    if any(hmax % c["h"] or vmax % c["v"] for c in fr.comps):
        fr.unsupported("a JPEG with fractional sampling ratios ("
                       + ", ".join(f"{c['h']}x{c['v']}" for c in fr.comps)
                       + "); only whole ratios decode")
    fr.hmax, fr.vmax = hmax, vmax
    fr.mcus_x = -(-w // (8 * hmax))
    fr.mcus_y = -(-h // (8 * vmax))
    for c in fr.comps:
        c["width"] = -(-w * c["h"] // hmax)  # downsampled_width
        c["height"] = -(-h * c["v"] // vmax)
        c["ratio"] = (hmax // c["h"], vmax // c["v"])
        c["coef"] = np.zeros((fr.mcus_y * c["v"], fr.mcus_x * c["h"], 64), np.int16)
        c["bits"] = np.full(64, -1)  # libjpeg's coef_bits: the last scan's Al, -1 if none
        c["prev"] = np.full(64, -1)  # coef_bits before the component's last scan


def _scan(fr: _Frame, header: bytes, data: memoryview) -> int:
    """Decode one scan; returns the bytes of entropy-coded data read."""
    fr.need(header, 1, "scan header")
    n = header[0]
    if not 1 <= n <= len(fr.comps):
        fr.fail(f"a scan of {n} components in a frame of {len(fr.comps)}")
    if len(header) != 4 + 2 * n:
        fr.fail(f"a scan header of {len(header)} bytes for {n} components")
    ids = {c["id"]: c for c in fr.comps}
    members, desc = [], []
    for i in range(n):
        cid, tables = header[1 + 2 * i], header[2 + 2 * i]
        if cid not in ids:
            fr.fail(f"a scan of component {cid}, which the frame does not have")
        if any(c["id"] == cid for c in members):
            fr.fail(f"a scan that names component {cid} twice")
        members.append(ids[cid])
        desc.append([tables >> 4, tables & 15])
    ss, se, a = header[1 + 2 * n], header[2 + 2 * n], header[3 + 2 * n]
    ah, al = a >> 4, a & 15
    if fr.progressive:
        # jdphuff.c's start_pass_phuff_decoder checks
        if (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or n != 1)) or \
                (ah and al != ah - 1) or al > 13:
            fr.fail(f"a progressive scan with impossible parameters Ss={ss}, Se={se}, "
                    f"Ah={ah}, Al={al}")
        used = (ss == 0 and ah == 0, ss > 0)  # the tables this kind of scan reads
    else:  # libjpeg only warns about other values here and decodes the whole band
        ss, se, ah, al = 0, 63, 0, 0
        used = (True, True)
    for c, d in zip(members, desc):
        if (used[0] and d[0] > 3) or (used[1] and d[1] > 3):
            fr.fail(f"a scan of component {c['id']} with Huffman tables {d[0]} (DC) and "
                    f"{d[1]} (AC); tables 0-3 decode")
        d[:] = [t if u else 0 for t, u in zip(d, used)]
    for c in members:  # libjpeg latches a component's table at its first scan
        if "qt" not in c:
            if c["tq"] not in fr.qt:
                fr.fail(f"no quantisation table {c['tq']}")
            c["qt"] = fr.qt[c["tq"]]
        # jdphuff.c's start_pass_phuff_decoder keeps the bits it replaces (0 in
        # the first scan) for the smoothing of rows the scan's data miss
        lo, hi = min(ss, 1), max(se, 9) + 1
        c["prev"][lo:hi] = c["bits"][lo:hi] if fr.scans else 0
        c["bits"][ss:se + 1] = al
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
    last = ctypes.c_long(0)  # the last MCU decoded from data
    args = (buf.ctypes.data, buf.size, ctypes.byref(end), ctypes.byref(last), n,
            table.ctypes.data, ptrs,
            fr.bits.ctypes.data, fr.vals.ctypes.data, mcus_x, mcus_y, fr.restart)
    if fr.progressive:
        err = _native().hi3d_jpeg_decode_progressive(*args, ss, se, ah, al)
    else:
        err = _native().hi3d_jpeg_decode_scan(*args)
    if err:
        kind = f" ({_SCAN_KINDS[ss > 0, ah > 0]} scan)" if fr.progressive else ""
        fr.fail(f"corrupt JPEG data{kind}: {_SCAN_ERRORS.get(err, err)}")
    fr.scans += 1
    row = last.value // mcus_x  # -1 where no MCU was read from data
    fr.last_good = row if n > 1 else row // members[0]["v"]
    return end.value


def _needs_smoothing(fr: _Frame) -> bool:
    """libjpeg-turbo's jdcoefct.c smoothing_ok at the end of a progressive
    file, which selects decompress_smooth_data: every component's DC known,
    its DC and first 9 AC quantisers nonzero, and some of those 9 AC
    coefficients unrefined (Al > 0) or never sent."""
    if not fr.progressive:
        return False
    first = _ZIGZAG[:10]
    if any(c["bits"][0] < 0 or not c["qt"][first].all() for c in fr.comps):
        return False
    return any((c["bits"][1:10] != 0).any() for c in fr.comps)


def _smoothed(fr: _Frame, c: Dict, table: np.ndarray) -> np.ndarray:
    """A component's coefficients as libjpeg-turbo's block smoothing leaves
    them (csrc/jpeg_decode.c hi3d_jpeg_smooth)."""
    out = c["coef"].copy()
    qt = np.ascontiguousarray(table, np.int32)
    # smoothing_ok latches the earlier bits only after more than one scan
    bits, prev = (np.ascontiguousarray(b[:10], np.int32)
                  for b in (c["bits"], c["prev"] if fr.scans > 1 else np.full(10, -1)))
    err = _native().hi3d_jpeg_smooth(
        c["coef"].ctypes.data, out.ctypes.data, out.shape[1], -(-c["width"] // 8),
        -(-c["height"] // 8), c["v"], fr.mcus_y, qt.ctypes.data, bits.ctypes.data,
        prev.ctypes.data, fr.last_good)
    if err:
        fr.fail(f"block smoothing failed ({err})")
    return out


def _components(fr: _Frame, smooth: bool = False) -> List[torch.Tensor]:
    """Each component's samples (1, height, width) int32: block-smoothed
    where `smooth`, dequantised (with the table latched at its first scan),
    inverse-transformed and cropped to its size."""
    out = []
    for c in fr.comps:
        table = c.get("qt", fr.qt.get(c["tq"]))
        if table is None:
            fr.fail(f"no quantisation table {c['tq']}")
        coef = _smoothed(fr, c, table) if smooth else c["coef"]
        coef = torch.from_numpy(coef.astype(np.int32)).reshape(1, *coef.shape[:2], 8, 8)
        qt = torch.from_numpy(table.astype(np.int32)).reshape(1, 8, 8)
        out.append(dequantize_idct(coef, qt)[:, :c["height"], :c["width"]])
    return out


def _colour_space(fr: _Frame) -> str:
    """libjpeg's default_decompress_parms: JFIF means YCbCr; else an Adobe
    marker's transform (3 components: 0 RGB, else YCbCr; 4: 0 CMYK, else
    YCCK); else the component ids ('R', 'G', 'B' is RGB) or CMYK."""
    n = len(fr.comps)
    if n == 1:
        return "grey"
    if n == 3:
        if fr.jfif:
            return "ycc"
        if fr.adobe_transform is not None:
            return "rgb" if fr.adobe_transform == 0 else "ycc"
        return "rgb" if [c["id"] for c in fr.comps] == [82, 71, 66] else "ycc"
    if fr.adobe_transform is None or fr.adobe_transform == 0:
        return "cmyk"
    return "ycck"


def decode_jpeg(blob: bytes, name: str = "<bytes>", from_file: bool = False,
                colour: Optional[str] = None) -> np.ndarray:
    """uint8 (H, W, 3) RGB, or (H, W, 1) for a grey JPEG; `name` labels
    the errors. Data that end too soon raise as `cv2.imdecode` fails on
    them: a single-scan file whose scan runs to the end of the data, a
    multi-scan (progressive) one without its EOI marker. With `from_file`
    they decode as `cv2.imread` reads a file, whose libjpeg source supplies
    an EOI at its end (the rest of a cut scan as libjpeg's zeros).

    `colour` overrides the colour space libjpeg would guess, as libtiff
    sets it for the JPEG strips of a TIFF (utils/tiff.py): "ycc" converts
    to RGB, "raw" returns the components as they are, (H, W, components)."""
    fr = _Frame(name)
    if not blob.startswith(SIGNATURE):
        fr.fail("not a JPEG file")
    if from_file:  # libjpeg's stdio source: past the end of a file, FF D9 for every read
        blob = blob + _FILE_END
    view = memoryview(blob)
    pos, scans, complete = 2, 0, False
    while True:
        m = _MARKER.search(blob, pos)
        if m is None:
            break
        kind = blob[m.start() + 1]
        pos = m.start() + 2
        if kind == 0xD9:  # EOI
            complete = True
            break
        if 0xD0 <= kind <= 0xD7 or kind == 0x01:
            continue
        if kind < 0xC0 or kind in (0xC8, 0xD8, 0xDE, 0xDF) or 0xF0 <= kind <= 0xFD:
            fr.fail(f"an unknown or misplaced JPEG marker 0xFF{kind:02X}")
        length = int.from_bytes(blob[pos:pos + 2], "big")
        if length < 2 or pos + length > len(blob):
            fr.fail(f"a truncated JPEG: its 0xFF{kind:02X} segment runs past the end")
        body = blob[pos + 2:pos + length]
        pos += length
        if kind in (0xC0, 0xC1, 0xC2):
            _read_sof(fr, body)
            fr.progressive = kind == 0xC2
            _layout(fr)
        elif kind in _UNSUPPORTED_SOF:
            fr.unsupported(f"{_UNSUPPORTED_SOF[kind]}; only baseline, extended sequential "
                           "and progressive Huffman JPEGs decode")
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
            if len(body) != 2:
                fr.fail(f"a restart interval segment of {len(body)} bytes (2 expected)")
            fr.restart = int.from_bytes(body, "big")
        elif kind == 0xDA:  # SOS
            if fr.size is None:
                fr.fail("a scan before the frame header")
            single = not scans and not fr.progressive and body[:1] == bytes([len(fr.comps)])
            pos += _scan(fr, body, view[pos:])
            scans += 1
            if single:  # libjpeg outputs a file whose first scan has every component from it
                if not from_file and _MARKER.search(blob, pos) is None:
                    fr.fail("a truncated JPEG: its scan runs to the end of the data")
                complete = True
                break
        elif kind == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
            fr.jfif = True
        elif kind == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            fr.adobe_transform = body[11]
    if fr.size is None or not scans:
        fr.fail("a JPEG without a frame or a scan")
    if not complete and not from_file:
        fr.fail("a truncated JPEG: no EOI marker")
    space = colour or _colour_space(fr)
    if space == "ycck":
        fr.unsupported(f"a YCCK JPEG (Adobe transform {fr.adobe_transform}); not supported")
    h, w = fr.size
    planes = [upsample(p, c["ratio"], h, w)
              for p, c in zip(_components(fr, _needs_smoothing(fr)), fr.comps)]
    if space == "grey":
        return planes[0][0].numpy().astype(np.uint8)[:, :, None]
    if space == "ycc" and len(planes) != 3:
        fr.fail(f"a YCbCr JPEG of {len(planes)} components")
    if space in ("rgb", "raw"):
        rgb = torch.stack(planes, dim=1)[0]
    elif space == "cmyk":
        rgb = cmyk_to_rgb(*planes)[0]
    else:
        rgb = ycc_to_rgb(*planes)[0]
    return rgb.permute(1, 2, 0).numpy().astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of a file, as cv2.imread reads it."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path, from_file=True)


def is_jpeg(blob: bytes) -> bool:
    return blob.startswith(SIGNATURE)

