"""MPEG-4 Part 2 (Visual) video without cv2 or imageio: a decoder for the
`mp4v` streams that libavcodec's `mpeg4` encoder writes under cv2's
VideoWriter (fourcc "mp4v"), which is how the JAX package's
`export_to_video` writes an mp4 where imageio has no ffmpeg plugin
(hi3d_tpu/utils/video.py:103-126).

The subset is the Simple Profile as that encoder writes it: the VOS, VO and
VOL headers (from the `esds` DecoderSpecificInfo or in-band), GOV headers,
and I- and P-VOPs of one video packet each: intra DC VLCs (or the DC as a
coefficient under intra_dc_vlc_thr), DC/AC prediction, the intra and inter
TCOEF tables with the three escapes, H.263 dequantisation and dquant,
median vector prediction, one vector or four a macroblock, half-sample
motion compensation with vop_rounding_type over the edge-extended
reference (unrestricted vectors), not_coded and intra macroblocks in
P-VOPs, any even frame size. The headers are parsed here and the
macroblocks in csrc/mpeg4_decode.c, whose IDCT is libavcodec's 8-bit
simple IDCT.

Every other tool raises `Unsupported` (h264.Unsupported, which
utils/video.import_video hands to imageio or cv2 where they import) naming
it: B- and S(GMC)-VOPs, N-VOPs (vop_coded 0), quarter-sample, interlace,
non-rectangular shape, sprites, scalability, data partitioning and
reversible VLC, NEWPRED, reduced resolution, resync markers, OBMC, MPEG
quantisation, more than 8 bits, complexity estimation headers, streams
from XviD (libavcodec decodes those with XviD's IDCT) and packed VOPs. A
damaged stream raises a ValueError naming where.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import cbuild
from .h264 import Unsupported

VOS, VOS_END, USER_DATA, GOV, VO, VOP = 0xB0, 0xB1, 0xB2, 0xB3, 0xB5, 0xB6
DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)  # intra_dc_vlc_thr -> the qscale the DC VLC stops at
MAX_SIDE = 8192
# the tools csrc/mpeg4_decode.c counts (its STAT_* order), for tests that
# show which ones a stream exercises
STATS = ("intra_in_p", "not_coded", "ac_pred", "dc_as_ac", "dquant", "escape1", "escape2",
         "escape3", "past_edge", "round_down", "four_mv")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _native() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            lib = cbuild.load("mpeg4_decode.c", "hi3d_mpeg4", "mpeg4.decode")
            lib.hi3d_mpeg4_decode_vop.argtypes = [p, l, l, i, i, i, i, i, i, i, i, i, p, p, p,
                                                  p, p, p, p, p, i]
            lib.hi3d_mpeg4_decode_vop.restype = i
            _lib = lib
    return _lib


class _Bits:
    """Big-endian bits of `data`; reading past the end raises."""

    def __init__(self, data: bytes, where: str, pos: int = 0):
        self.value = int.from_bytes(data, "big") if data else 0
        self.nbits, self.pos, self.where = 8 * len(data), pos, where

    def u(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise ValueError(f"{self.where}: the header ends after {self.nbits} bits")
        self.pos += n
        return (self.value >> (self.nbits - self.pos)) & ((1 << n) - 1)


@dataclass
class Vol:
    """What the macroblock layer needs of a video_object_layer header."""

    width: int
    height: int
    time_bits: int


def start_codes(data: bytes) -> List[Tuple[int, int, int]]:
    """(start code value, payload start, payload end) of each start code
    (00 00 01 xx) in `data`."""
    found = []
    pos = data.find(b"\x00\x00\x01")
    while pos >= 0 and pos + 3 < len(data):
        nxt = data.find(b"\x00\x00\x01", pos + 4)
        found.append((data[pos + 3], pos + 4, nxt if nxt >= 0 else len(data)))
        pos = nxt
    return found


def _visual_object(data: bytes, where: str) -> None:
    r = _Bits(data, where)
    if r.u(1):
        r.u(7)  # visual_object_verid, visual_object_priority
    kind = r.u(4)
    if kind != 1:
        raise Unsupported(f"{where}: visual_object_type {kind} (not video)")


def parse_vol(data: bytes, where: str) -> Vol:
    """The video_object_layer header after its start code (ISO/IEC
    14496-2 6.2.3)."""
    r = _Bits(data, where)
    r.u(1)  # random_accessible_vol
    r.u(8)  # video_object_type_indication
    verid = 1
    if r.u(1):  # is_object_layer_identifier
        verid = r.u(4)
        r.u(3)
    if r.u(4) == 15:  # aspect_ratio_info: extended PAR
        r.u(16)
    if r.u(1):  # vol_control_parameters
        chroma = r.u(2)
        if chroma != 1:
            raise Unsupported(f"{where}: chroma_format {chroma} (only 4:2:0 decodes here)")
        r.u(1)  # low_delay
        if r.u(1):  # vbv_parameters
            for n in (15, 1, 15, 1, 15, 1, 3, 11, 1, 15, 1):
                r.u(n)
    shape = r.u(2)
    if shape:
        raise Unsupported(f"{where}: non-rectangular shape (video_object_layer_shape {shape})")
    r.u(1)
    resolution = r.u(16)
    if resolution == 0:
        raise ValueError(f"{where}: vop_time_increment_resolution 0")
    time_bits = max(1, (resolution - 1).bit_length())
    r.u(1)
    if r.u(1):  # fixed_vop_rate
        r.u(time_bits)
    r.u(1)
    width = r.u(13)
    r.u(1)
    height = r.u(13)
    r.u(1)
    if not (0 < width <= MAX_SIDE and 0 < height <= MAX_SIDE):
        raise ValueError(f"{where}: a picture of {width}x{height}")
    if width % 2 or height % 2:
        raise Unsupported(f"{where}: an odd frame size {width}x{height}")
    if r.u(1):
        raise Unsupported(f"{where}: interlace")
    if not r.u(1):
        raise Unsupported(f"{where}: OBMC (obmc_disable 0)")
    sprite = r.u(1 if verid == 1 else 2)
    if sprite:
        raise Unsupported(f"{where}: {'sprites' if sprite == 1 else 'GMC'} (sprite_enable "
                          f"{sprite})")
    if r.u(1):
        raise Unsupported(f"{where}: more than 8 bits a sample (not_8_bit)")
    if r.u(1):
        raise Unsupported(f"{where}: MPEG quantisation (quant_type 1)")
    if verid != 1 and r.u(1):
        raise Unsupported(f"{where}: quarter-sample motion (quarter_sample)")
    if not r.u(1):
        raise Unsupported(f"{where}: complexity estimation headers")
    if not r.u(1):
        raise Unsupported(f"{where}: resync markers (resync_marker_disable 0)")
    if r.u(1):
        raise Unsupported(f"{where}: data partitioning"
                          f"{' and reversible VLC' if r.u(1) else ''}")
    if verid != 1:
        if r.u(1):
            raise Unsupported(f"{where}: NEWPRED")
        if r.u(1):
            raise Unsupported(f"{where}: reduced resolution VOPs")
    if r.u(1):
        raise Unsupported(f"{where}: scalability")
    return Vol(width, height, time_bits)


@dataclass
class VopHeader:
    coding_type: int  # 0 I, 1 P
    rounding: int
    dc_threshold: int
    qscale: int
    fcode: int
    bitpos: int  # of the first macroblock, from the VOP start code's payload


def parse_vop(data: bytes, vol: Vol, where: str) -> VopHeader:
    """The video_object_plane header after its start code (6.2.5)."""
    r = _Bits(data, where)
    kind = r.u(2)
    if kind == 2:
        raise Unsupported(f"{where}: a B-VOP")
    if kind == 3:
        raise Unsupported(f"{where}: an S(GMC)-VOP")
    while r.u(1):  # modulo_time_base
        pass
    r.u(1)
    r.u(vol.time_bits)
    if not r.u(1):  # libavcodec guesses vop_time_increment's width again without it
        raise ValueError(f"{where}: no marker bit after vop_time_increment")
    if not r.u(1):
        raise Unsupported(f"{where}: an N-VOP (vop_coded 0)")
    rounding = r.u(1) if kind == 1 else 0
    threshold = DC_THRESHOLD[r.u(3)]
    qscale = r.u(5)
    if qscale == 0:
        raise ValueError(f"{where}: vop_quant 0")
    fcode = 1
    if kind == 1:
        fcode = r.u(3)
        if fcode == 0:
            raise ValueError(f"{where}: vop_fcode_forward 0")
    return VopHeader(kind, rounding, threshold, qscale, fcode, r.pos)


def parse_headers(data: bytes, where: str,
                  vol: Optional[Vol] = None) -> Tuple[Optional[Vol], List[int]]:
    """Applies the VOS, VO, VOL, user-data and GOV headers in `data` and
    returns the layer in force and the payload offsets of its VOPs."""
    vops = []
    for code, start, end in start_codes(data):
        payload = data[start:end]
        if code == VO:
            _visual_object(payload, f"{where}: visual_object")
        elif 0x20 <= code <= 0x2F:
            layer = parse_vol(payload, f"{where}: video_object_layer")
            if vol is not None and (layer.width, layer.height) != (vol.width, vol.height):
                raise ValueError(f"{where}: the layer changes from {vol.width}x{vol.height} to "
                                 f"{layer.width}x{layer.height}")
            vol = layer
        elif code == USER_DATA and payload.startswith(b"XviD"):
            raise Unsupported(f"{where}: an XviD stream (libavcodec decodes it with XviD's IDCT)")
        elif code == VOP:
            vops.append(start)
        elif code not in (VOS, VOS_END, USER_DATA, GOV) and code > 0x1F:
            raise Unsupported(f"{where}: start code 0x{code:02X}")
    return vol, vops


def decode(config: bytes, samples: Sequence[bytes], name: str = "mpeg4",
           stats: Optional[dict] = None) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(Y, Cb, Cr) of every sample (one VOP each), in decoding order, which
    is display order for streams of I- and P-VOPs. `config` holds the
    decoder-specific headers (the esds DecoderSpecificInfo; empty when the
    stream carries its VOL in-band). When given, `stats` receives the
    count of each tool of STATS and of "P" and "I" VOPs."""
    vol, vops = parse_headers(bytes(config), f"{name}: esds")
    if vops:
        raise ValueError(f"{name}: esds: a VOP in the decoder configuration")
    lib = _native()
    msg = ctypes.create_string_buffer(256)
    counts = np.zeros(len(STATS), np.int64)
    out: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    ref = None
    for i, sample in enumerate(samples):
        where = f"{name}: sample {i}"
        data = bytes(sample)
        vol, vops = parse_headers(data, where, vol)
        if not vops:
            raise ValueError(f"{where}: no VOP")
        if len(vops) > 1:
            raise Unsupported(f"{where}: {len(vops)} packed VOPs in one sample")
        if vol is None:
            raise ValueError(f"{where}: a VOP before any video_object_layer header")
        # a VOP header is a few bytes; the slice keeps its bit reader small
        head = parse_vop(data[vops[0]:vops[0] + 256], vol, f"{where}: VOP")
        if head.coding_type == 1 and ref is None:
            raise ValueError(f"{where}: a P-VOP with no picture before it")
        mb_w, mb_h = -(-vol.width // 16), -(-vol.height // 16)
        planes = (np.empty((16 * mb_h, 16 * mb_w), np.uint8),
                  np.empty((8 * mb_h, 8 * mb_w), np.uint8),
                  np.empty((8 * mb_h, 8 * mb_w), np.uint8))
        refs = ref if ref is not None else (None, None, None)
        buf = np.frombuffer(data, np.uint8)
        rc = lib.hi3d_mpeg4_decode_vop(
            buf.ctypes.data, buf.size, 8 * vops[0] + head.bitpos, mb_w, mb_h, vol.width,
            vol.height, head.coding_type, head.qscale, head.rounding, head.fcode,
            head.dc_threshold, *(p.ctypes.data if p is not None else None for p in refs),
            *(p.ctypes.data for p in planes), counts.ctypes.data, msg, len(msg))
        if rc == -2:
            raise MemoryError(f"{where}: out of memory")
        if rc != 0:
            raise ValueError(f"{where}: {msg.value.decode(errors='replace') or f'error {rc}'}")
        ref = planes
        if stats is not None:
            kind = "IP"[head.coding_type]
            stats[kind] = stats.get(kind, 0) + 1
        w, h = vol.width, vol.height
        out.append((planes[0][:h, :w], planes[1][:h // 2, :w // 2], planes[2][:h // 2, :w // 2]))
    if stats is not None:
        for key, n in zip(STATS, counts.tolist()):
            stats[key] = stats.get(key, 0) + n
    return out
