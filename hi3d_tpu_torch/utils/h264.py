"""H.264 intra video without cv2 or imageio: the encoder the port writes its
mp4s with, and a decoder for the streams it writes (the JAX package writes
through imageio's ffmpeg or cv2, hi3d_tpu/utils/video.py:84-127, and reads
back through them, :130-156).

The stream (`encode`): Constrained Baseline (profile_idc 66,
constraint_set0/1), `level_idc` from the frame size and rate (Table A-1);
one SPS and one PPS; every picture an IDR I slice with CAVLC; macroblocks
Intra16x16, Intra4x4 or I_PCM, chroma DC/H/V/plane (csrc/h264_encode.c);
`disable_deblocking_filter_idc` 1, so the decoded picture is the encoder's
reconstruction; frame cropping for even sizes that are not whole
macroblocks; a VUI with BT.601 primaries, transfer and matrix (6) and
limited range, the frame rate, and no reordering.

Colour: RGB -> Y'CbCr BT.601 limited range, the integer formula at the top
of csrc/h264_encode.c (chroma the rounded mean of each 2x2, swscale's
default matrix, which ffmpeg's decoders invert); `to_rgb` inverts it with
the integer formula of csrc/h264_decode.c.

Quality: JAX's `quality` (0-10) becomes the QP as imageio-ffmpeg turns it
into libx264's CRF, int((1 - quality / 10) * 51): 5 at the default 9.

The decoder (`decode`) reads I slices, IDR or not, one or more a picture,
with I_PCM, Intra16x16 and Intra4x4 macroblocks, CAVLC, cropping and
pic_order_cnt_type 0 or 2, in decoding order (all-intra streams need no
reordering). Parameter sets and slice headers are parsed here; every field
that sizes or indexes something is checked here and again in C. A stream
outside that subset (CABAC, P or B slices, a profile above Baseline,
interlace, the 8x8 transform, the loop filter on, ...) raises
`Unsupported`, a ValueError that names what it found; a damaged one raises a
ValueError that names where.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import cbuild

PROFILE_BASELINE = 66
MAX_MBS = 139264  # MaxFS of level 6.2, the largest picture the decoder takes

# Table A-1: (level_idc, MaxMBPS, MaxFS)
LEVELS = ((10, 1485, 99), (11, 3000, 396), (12, 6000, 396), (13, 11880, 396), (20, 11880, 396),
          (21, 19800, 792), (22, 20250, 1620), (30, 40500, 1620), (31, 108000, 3600),
          (32, 216000, 5120), (40, 245760, 8192), (41, 245760, 8192), (42, 522240, 8704),
          (50, 589824, 22080), (51, 983040, 36864), (52, 2073600, 36864), (60, 4177920, 139264),
          (61, 8355840, 139264), (62, 16711680, 139264))


class Unsupported(ValueError):
    """A stream outside the decoder's subset; names what it found."""


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _native() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            enc = cbuild.load("h264_encode.c", "hi3d_h264enc", "h264.encode")
            enc.hi3d_h264_encode_frame.argtypes = [p, i, i, i, i, i, i, i, i, i, p, l, p, p, p, p]
            enc.hi3d_h264_encode_frame.restype = i
            enc.hi3d_h264_rgb_to_yuv420.argtypes = [p, i, i, p, p, p]
            enc.hi3d_h264_rgb_to_yuv420.restype = i
            dec = cbuild.load("h264_decode.c", "hi3d_h264dec", "h264.decode")
            dec.hi3d_h264_decode_slice.argtypes = [p, l, l, i, i, i, i, i, i, p, p, p, p, p, p, i]
            dec.hi3d_h264_decode_slice.restype = i
            dec.hi3d_h264_yuv_to_rgb.argtypes = [p, p, p, i, i, i, i, p]
            dec.hi3d_h264_yuv_to_rgb.restype = i
            _lib = (enc, dec)
    return _lib


def quality_to_qp(quality: float) -> int:
    """imageio-ffmpeg's quality -> libx264 CRF mapping, as the QP."""
    if not 0 <= quality <= 10:
        raise ValueError(f"quality {quality} outside 0..10")
    return int((1 - quality / 10) * 51)


def level_idc(width: int, height: int, fps: float) -> int:
    """The lowest level of Table A-1 whose MaxFS, MaxMBPS and frame
    dimension limit (sqrt(8 MaxFS) macroblocks) hold the stream."""
    mb_w, mb_h = -(-width // 16), -(-height // 16)
    for level, mbps, fs in LEVELS:
        side = (8 * fs) ** 0.5
        if mb_w * mb_h <= fs and mb_w <= side and mb_h <= side and mb_w * mb_h * fps <= mbps:
            return level
    raise ValueError(f"{width}x{height} at {fps} fps exceeds level 6.2")


# ---------------------------------------------------------------- bitstreams

class _BitWriter:
    def __init__(self):
        self.bits: List[str] = []

    def u(self, n: int, v: int) -> None:
        self.bits.append(format(v, f"0{n}b") if n else "")

    def ue(self, v: int) -> None:
        x = format(v + 1, "b")
        self.bits.append("0" * (len(x) - 1) + x)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp(self) -> bytes:
        s = "".join(self.bits) + "1"
        s += "0" * (-len(s) % 8)
        return int(s, 2).to_bytes(len(s) // 8, "big")


def escape(rbsp: bytes) -> bytes:
    """Emulation prevention: a 0x03 after every two zero bytes that precede
    a byte <= 3."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def unescape(nal: bytes) -> bytes:
    return nal.replace(b"\x00\x00\x03", b"\x00\x00")


class _BitReader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what
        self.n = len(data) * 8

    def u(self, n: int) -> int:
        if self.pos + n > self.n:
            raise ValueError(f"{self.what}: truncated")
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError(f"{self.what}: an Exp-Golomb code longer than 32 bits")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def more_data(self) -> bool:
        """more_rbsp_data(): bits remain before rbsp_stop_one_bit."""
        last = len(self.data) - 1
        while last >= 0 and self.data[last] == 0:
            last -= 1
        if last < 0:
            return False
        tz = (self.data[last] & -self.data[last]).bit_length() - 1
        return self.pos < last * 8 + 7 - tz


def _ranged(v: int, lo: int, hi: int, what: str) -> int:
    if not lo <= v <= hi:
        raise ValueError(f"{what} {v} outside {lo}..{hi}")
    return v


# ------------------------------------------------------------ parameter sets

def write_sps(width: int, height: int, fps: int, poc_type: int = 2) -> bytes:
    """The SPS NAL unit (with its header byte) of the encoder's streams."""
    mb_w, mb_h = -(-width // 16), -(-height // 16)
    w = _BitWriter()
    w.u(8, PROFILE_BASELINE)
    w.u(8, 0b11000000)  # constraint_set0 and constraint_set1: Constrained Baseline
    w.u(8, level_idc(width, height, fps))
    w.ue(0)  # seq_parameter_set_id
    w.ue(0)  # log2_max_frame_num_minus4: frame_num is 4 bits
    w.ue(poc_type)
    if poc_type == 0:
        w.ue(4)  # log2_max_pic_order_cnt_lsb_minus4: 8 bits
    w.ue(1)  # max_num_ref_frames
    w.u(1, 0)  # gaps_in_frame_num_value_allowed_flag
    w.ue(mb_w - 1)
    w.ue(mb_h - 1)
    w.u(1, 1)  # frame_mbs_only_flag
    w.u(1, 1)  # direct_8x8_inference_flag
    crop = (mb_w * 16 - width) // 2, (mb_h * 16 - height) // 2
    w.u(1, int(any(crop)))
    if any(crop):
        w.ue(0)
        w.ue(crop[0])
        w.ue(0)
        w.ue(crop[1])
    w.u(1, 1)  # vui_parameters_present_flag
    w.u(1, 0)  # aspect_ratio_info_present_flag
    w.u(1, 0)  # overscan_info_present_flag
    w.u(1, 1)  # video_signal_type_present_flag
    w.u(3, 5)  # video_format: unspecified
    w.u(1, 0)  # video_full_range_flag: limited range
    w.u(1, 1)  # colour_description_present_flag
    w.u(8, 6)  # colour_primaries: BT.601 (SMPTE 170M)
    w.u(8, 6)  # transfer_characteristics
    w.u(8, 6)  # matrix_coefficients
    w.u(1, 0)  # chroma_loc_info_present_flag
    w.u(1, 1)  # timing_info_present_flag
    w.u(32, 1)  # num_units_in_tick
    w.u(32, 2 * fps)  # time_scale: two ticks a frame
    w.u(1, 1)  # fixed_frame_rate_flag
    w.u(1, 0)  # nal_hrd_parameters_present_flag
    w.u(1, 0)  # vcl_hrd_parameters_present_flag
    w.u(1, 0)  # pic_struct_present_flag
    w.u(1, 1)  # bitstream_restriction_flag
    w.u(1, 1)  # motion_vectors_over_pic_boundaries_flag
    w.ue(0)  # max_bytes_per_pic_denom
    w.ue(0)  # max_bits_per_mb_denom
    w.ue(0)  # log2_max_mv_length_horizontal
    w.ue(0)  # log2_max_mv_length_vertical
    w.ue(0)  # max_num_reorder_frames
    w.ue(1)  # max_dec_frame_buffering
    return b"\x67" + escape(w.rbsp())


def write_pps(qp: int) -> bytes:
    """The PPS NAL unit of the encoder's streams: CAVLC, QP `qp`, the loop
    filter's control present (each slice turns it off)."""
    w = _BitWriter()
    w.ue(0)  # pic_parameter_set_id
    w.ue(0)  # seq_parameter_set_id
    w.u(1, 0)  # entropy_coding_mode_flag: CAVLC
    w.u(1, 0)  # bottom_field_pic_order_in_frame_present_flag
    w.ue(0)  # num_slice_groups_minus1
    w.ue(0)
    w.ue(0)  # num_ref_idx_l0/l1_default_active_minus1
    w.u(1, 0)
    w.u(2, 0)  # weighted_pred_flag, weighted_bipred_idc
    w.se(qp - 26)  # pic_init_qp_minus26
    w.se(0)  # pic_init_qs_minus26
    w.se(0)  # chroma_qp_index_offset
    w.u(1, 1)  # deblocking_filter_control_present_flag
    w.u(1, 0)  # constrained_intra_pred_flag
    w.u(1, 0)  # redundant_pic_cnt_present_flag
    return b"\x68" + escape(w.rbsp())


@dataclass
class SPS:
    sps_id: int
    log2_max_frame_num: int
    poc_type: int
    log2_max_poc_lsb: int
    mb_w: int
    mb_h: int
    crop: Tuple[int, int, int, int]  # left, right, top, bottom in samples

    @property
    def size(self) -> Tuple[int, int]:
        """(width, height) after cropping."""
        l, r, t, b = self.crop
        return self.mb_w * 16 - l - r, self.mb_h * 16 - t - b


@dataclass
class PPS:
    pps_id: int
    sps_id: int
    bottom_field_poc: bool
    qp: int
    cqp_offset: int
    deblocking_control: bool


PROFILES = {66: "Baseline", 77: "Main", 88: "Extended", 100: "High", 110: "High 10",
            122: "High 4:2:2", 244: "High 4:4:4 Predictive", 44: "CAVLC 4:4:4 Intra",
            83: "Scalable Baseline", 86: "Scalable High", 118: "Multiview High",
            128: "Stereo High", 138: "Multiview Depth High", 139: "Enhanced Multiview Depth High",
            134: "MFC High", 135: "MFC Depth High"}


def parse_sps(nal: bytes, where: str) -> SPS:
    r = _BitReader(unescape(nal[1:]), f"{where}: SPS")
    profile = r.u(8)
    r.u(8)
    r.u(8)  # constraint flags, level_idc
    if profile != PROFILE_BASELINE:
        raise Unsupported(f"{where}: H.264 {PROFILES.get(profile, 'unknown')} profile "
                          f"(profile_idc {profile}); only Baseline (66) decodes here")
    sps_id = _ranged(r.ue(), 0, 31, f"{where}: seq_parameter_set_id")
    log2_frame_num = _ranged(r.ue(), 0, 12, f"{where}: log2_max_frame_num_minus4") + 4
    poc_type = _ranged(r.ue(), 0, 2, f"{where}: pic_order_cnt_type")
    log2_poc = 0
    if poc_type == 0:
        log2_poc = _ranged(r.ue(), 0, 12, f"{where}: log2_max_pic_order_cnt_lsb_minus4") + 4
    elif poc_type == 1:
        raise Unsupported(f"{where}: pic_order_cnt_type 1; only 0 and 2 decode here")
    r.ue()  # max_num_ref_frames
    r.u(1)  # gaps_in_frame_num_value_allowed_flag
    mb_w = _ranged(r.ue(), 0, 1023, f"{where}: pic_width_in_mbs_minus1") + 1
    mb_h = _ranged(r.ue(), 0, 1023, f"{where}: pic_height_in_map_units_minus1") + 1
    if mb_w * mb_h > MAX_MBS:
        raise ValueError(f"{where}: {mb_w}x{mb_h} macroblocks exceed level 6.2's {MAX_MBS}")
    if not r.u(1):
        raise Unsupported(f"{where}: interlace (frame_mbs_only_flag 0); only progressive "
                          "frames decode here")
    r.u(1)  # direct_8x8_inference_flag
    crop = (0, 0, 0, 0)
    if r.u(1):
        crop = tuple(2 * r.ue() for _ in range(4))
        if crop[0] + crop[1] >= mb_w * 16 or crop[2] + crop[3] >= mb_h * 16:
            raise ValueError(f"{where}: frame cropping {crop} leaves no picture")
    # the VUI is not needed to decode
    return SPS(sps_id, log2_frame_num, poc_type, log2_poc, mb_w, mb_h, crop)


def parse_pps(nal: bytes, where: str) -> PPS:
    r = _BitReader(unescape(nal[1:]), f"{where}: PPS")
    pps_id = _ranged(r.ue(), 0, 255, f"{where}: pic_parameter_set_id")
    sps_id = _ranged(r.ue(), 0, 31, f"{where}: seq_parameter_set_id")
    if r.u(1):
        raise Unsupported(f"{where}: CABAC (entropy_coding_mode_flag 1); only CAVLC decodes here")
    bottom = bool(r.u(1))
    if r.ue():
        raise Unsupported(f"{where}: slice groups (num_slice_groups_minus1 > 0)")
    r.ue()
    r.ue()
    r.u(1)
    r.u(2)
    qp = 26 + _ranged(r.se(), -26, 25, f"{where}: pic_init_qp_minus26")
    r.se()
    cqp = _ranged(r.se(), -12, 12, f"{where}: chroma_qp_index_offset")
    deblocking = bool(r.u(1))
    r.u(1)  # constrained_intra_pred_flag: all-intra pictures predict from intra only
    if r.u(1):
        raise Unsupported(f"{where}: redundant pictures (redundant_pic_cnt_present_flag 1)")
    if r.more_data():
        if r.u(1):
            raise Unsupported(f"{where}: the 8x8 transform (transform_8x8_mode_flag 1)")
        if r.u(1):
            raise Unsupported(f"{where}: scaling matrices (pic_scaling_matrix_present_flag 1)")
    return PPS(pps_id, sps_id, bottom, qp, cqp, deblocking)


SLICE_TYPES = {0: "P", 1: "B", 2: "I", 3: "SP", 4: "SI"}


def _slice_header(rbsp: bytes, nal_type: int, ref_idc: int, sps: Dict[int, SPS],
                  pps: Dict[int, PPS], where: str):
    """(SPS, PPS, first_mb_in_slice, slice QP, bit position of slice_data)"""
    r = _BitReader(rbsp, f"{where}: slice header")
    first_mb = r.ue()
    slice_type = _ranged(r.ue(), 0, 9, f"{where}: slice_type") % 5
    if slice_type != 2:
        raise Unsupported(f"{where}: a {SLICE_TYPES[slice_type]} slice; only I slices "
                          "decode here")
    pps_id = r.ue()
    if pps_id not in pps:
        raise ValueError(f"{where}: slice names PPS {pps_id}, which the stream does not hold")
    p = pps[pps_id]
    if p.sps_id not in sps:
        raise ValueError(f"{where}: PPS {pps_id} names SPS {p.sps_id}, which the stream "
                         "does not hold")
    s = sps[p.sps_id]
    if first_mb >= s.mb_w * s.mb_h:
        raise ValueError(f"{where}: first_mb_in_slice {first_mb} outside the picture's "
                         f"{s.mb_w * s.mb_h} macroblocks")
    r.u(s.log2_max_frame_num)  # frame_num
    if nal_type == 5:
        r.ue()  # idr_pic_id
    if s.poc_type == 0:
        r.u(s.log2_max_poc_lsb)
        if p.bottom_field_poc:
            r.se()
    if ref_idc:
        if nal_type == 5:
            r.u(2)
        elif r.u(1):  # adaptive_ref_pic_marking_mode_flag
            for _ in range(64):
                op = r.ue()
                if op == 0:
                    break
                if op in (1, 2, 3, 6):
                    r.ue()
                if op == 3:
                    r.ue()
                if op == 4:
                    r.ue()
            else:
                raise ValueError(f"{where}: memory_management_control_operation list without "
                                 "its end")
    qp = p.qp + r.se()
    if not 0 <= qp <= 51:
        raise ValueError(f"{where}: slice QP {qp} outside 0..51")
    idc = r.ue() if p.deblocking_control else 0
    if idc != 1:
        raise Unsupported(f"{where}: the deblocking filter on (disable_deblocking_filter_idc "
                          f"{idc}); only streams without it decode here")
    return s, p, first_mb, qp, r.pos


# --------------------------------------------------------------- encoding

@dataclass
class Encoded:
    """An encoded clip: the parameter sets, one MP4 sample a picture
    (4-byte length-prefixed NAL units) and the encoder's reconstruction (the
    decoded pictures), as cropped Y, Cb, Cr planes a picture."""

    sps: bytes
    pps: bytes
    samples: List[bytes]
    recon: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]


def _threads(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 1))


def encode(frames: Sequence[np.ndarray], qp: int, fps: int, *, slice_rows: int = 0,
           all_idr: bool = True, poc_type: int = 2) -> Encoded:
    """Encodes (H, W, 3) uint8 RGB frames of one even size at `qp`, the
    pictures in parallel host threads. `slice_rows` > 0 starts a slice every
    that many macroblock rows; `all_idr` False makes every picture after the
    first a non-IDR I picture (with `poc_type` 0 that writes POC lsbs);
    both exist to give the decoder streams it must read."""
    frames = [np.ascontiguousarray(f) for f in frames]
    if not frames:
        raise ValueError("no frames to encode")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.ndim != 3 or f.shape != (h, w, 3):
            raise ValueError(f"frames must be ({h}, {w}, 3) uint8; got {f.shape} {f.dtype}")
    if h % 2 or w % 2:
        raise ValueError(f"a {w}x{h} frame has an odd side, which yuv420p cannot hold")
    if not 0 <= qp <= 51:
        raise ValueError(f"QP {qp} outside 0..51")
    sps, pps = write_sps(w, h, fps, poc_type), write_pps(qp)
    mb_w, mb_h = -(-w // 16), -(-h // 16)
    cap = mb_w * mb_h * 600 + 1024
    enc = _native()[0]

    def one(i: int):
        rec = [np.empty((mb_h * 16, mb_w * 16), np.uint8),
               np.empty((mb_h * 8, mb_w * 8), np.uint8), np.empty((mb_h * 8, mb_w * 8), np.uint8)]
        out = np.empty(cap, np.uint8)
        n = ctypes.c_long(0)
        idr = all_idr or i == 0
        rc = enc.hi3d_h264_encode_frame(
            frames[i].ctypes.data, w, h, qp, slice_rows, 5 if idr else 1, i % 2,
            0 if idr else i % 16, poc_type, (2 * i) % 256, out.ctypes.data, cap,
            ctypes.byref(n), rec[0].ctypes.data, rec[1].ctypes.data, rec[2].ctypes.data)
        if rc != 0:
            raise RuntimeError(f"h264 encode of frame {i} failed ({rc})")
        return out[:n.value].tobytes(), (rec[0][:h, :w], rec[1][:h // 2, :w // 2],
                                         rec[2][:h // 2, :w // 2])

    with ThreadPoolExecutor(_threads(len(frames))) as pool:
        done = list(pool.map(one, range(len(frames))))
    return Encoded(sps, pps, [d[0] for d in done], [d[1] for d in done])


# --------------------------------------------------------------- decoding

def split_sample(sample: bytes, length_size: int, where: str) -> List[bytes]:
    """The NAL units of an MP4 sample (length-prefixed)."""
    nals, pos = [], 0
    while pos < len(sample):
        if pos + length_size > len(sample):
            raise ValueError(f"{where}: a NAL length field cut by the sample's end")
        n = int.from_bytes(sample[pos:pos + length_size], "big")
        pos += length_size
        if n == 0 or pos + n > len(sample):
            raise ValueError(f"{where}: a NAL unit of {n} bytes in {len(sample) - pos} left")
        nals.append(sample[pos:pos + n])
        pos += n
    return nals


class Decoder:
    """Decodes pictures of one stream; the parameter sets come from the
    container (`avcC`) and may be replaced in-band."""

    def __init__(self, sps_nals: Sequence[bytes], pps_nals: Sequence[bytes], name: str):
        self.name = name
        self.sps: Dict[int, SPS] = {}
        self.pps: Dict[int, PPS] = {}
        for nal in sps_nals:
            self._param_set(nal, f"{name}: avcC")
        for nal in pps_nals:
            self._param_set(nal, f"{name}: avcC")
        self.size: Optional[Tuple[int, int]] = None

    def _param_set(self, nal: bytes, where: str) -> None:
        if not nal:
            raise ValueError(f"{where}: an empty NAL unit")
        kind = nal[0] & 31
        if kind == 7:
            s = parse_sps(nal, where)
            self.sps[s.sps_id] = s
        elif kind == 8:
            p = parse_pps(nal, where)
            self.pps[p.pps_id] = p
        else:
            raise ValueError(f"{where}: NAL unit type {kind} where a parameter set belongs")

    def slices(self, nals: Sequence[bytes], where: str):
        """Parses the picture's NAL units in order (parameter sets update the
        decoder); returns its slices as (rbsp, SPS, PPS, first_mb, qp, bit
        position)."""
        out = []
        for nal in nals:
            if nal[0] & 0x80:
                raise ValueError(f"{where}: forbidden_zero_bit set")
            kind, ref_idc = nal[0] & 31, nal[0] >> 5
            if kind in (7, 8):
                self._param_set(nal, where)
            elif kind in (1, 5):
                rbsp = unescape(nal[1:])
                out.append((rbsp, *_slice_header(rbsp, kind, ref_idc, self.sps, self.pps, where)))
            elif kind in (2, 3, 4):
                raise Unsupported(f"{where}: data partitioning (NAL unit type {kind}); only "
                                  "whole slices decode here")
            elif kind in (14, 15, 20, 21):
                raise Unsupported(f"{where}: an SVC/MVC NAL unit (type {kind})")
            # 6 SEI, 9 access unit delimiter, 10-12 ends and filler, ...: nothing to decode
        if not out:
            raise ValueError(f"{where}: no slice")
        return out

    def picture(self, slices, where: str):
        """Decodes one picture from its slices (`slices`); returns cropped
        (Y, Cb, Cr)."""
        dec = _native()[1]
        s = slices[0][1]
        if any(x[1] is not s for x in slices):
            raise ValueError(f"{where}: slices of one picture under two SPSs")
        planes = [np.zeros((s.mb_h * 16, s.mb_w * 16), np.uint8),
                  np.zeros((s.mb_h * 8, s.mb_w * 8), np.uint8),
                  np.zeros((s.mb_h * 8, s.mb_w * 8), np.uint8)]
        owner = np.full(s.mb_w * s.mb_h, -1, np.int32)
        msg = ctypes.create_string_buffer(160)
        end = ctypes.c_int(0)
        for k, (rbsp, _, p, first_mb, qp, bitpos) in enumerate(slices):
            buf = np.frombuffer(rbsp, np.uint8)
            if buf.size == 0:
                raise ValueError(f"{where}: an empty slice")
            rc = dec.hi3d_h264_decode_slice(
                buf.ctypes.data, buf.size, bitpos, s.mb_w, s.mb_h, first_mb, qp, p.cqp_offset, k,
                owner.ctypes.data, planes[0].ctypes.data, planes[1].ctypes.data,
                planes[2].ctypes.data, ctypes.byref(end), msg, len(msg))
            if rc == -2:
                raise MemoryError(f"{where}: out of memory")
            if rc != 0:
                raise ValueError(f"{where}: slice {k}: {msg.value.decode() or f'error {rc}'}")
        missing = int((owner < 0).sum())
        if missing:
            raise ValueError(f"{where}: the slices leave {missing} of {owner.size} macroblocks "
                             "undecoded")
        l, r, t, b = s.crop
        w, h = s.size
        return (planes[0][t:t + h, l:l + w], planes[1][t // 2:(t + h) // 2, l // 2:(l + w) // 2],
                planes[2][t // 2:(t + h) // 2, l // 2:(l + w) // 2])


def decode(sps_nals: Sequence[bytes], pps_nals: Sequence[bytes], samples: Sequence[bytes],
           length_size: int = 4, name: str = "h264") -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(Y, Cb, Cr) of every sample (one picture each, in decoding order).
    Headers are parsed in order (in-band parameter sets apply to the
    samples after them); the pictures decode in parallel host threads."""
    d = Decoder(sps_nals, pps_nals, name)
    parsed = []
    for i, sample in enumerate(samples):
        where = f"{name}: sample {i}"
        sl = d.slices(split_sample(sample, length_size, where), where)
        size = sl[0][1].size
        if d.size is None:
            d.size = size
        elif size != d.size:
            raise ValueError(f"{where}: picture size {size} after {d.size}")
        if size[0] % 2 or size[1] % 2:
            raise ValueError(f"{where}: a cropped size {size} with an odd side")
        parsed.append((sl, where))
    with ThreadPoolExecutor(_threads(len(parsed))) as pool:
        return list(pool.map(lambda a: d.picture(*a), parsed))


def rgb_to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The encoder's colour conversion alone (csrc/h264_encode.c): Y, Cb, Cr
    of an (H, W, 3) uint8 frame of even sides."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    if rgb.shape != (h, w, 3) or h % 2 or w % 2:
        raise ValueError(f"rgb_to_yuv420 takes (H, W, 3) of even sides; got {rgb.shape}")
    out = (np.empty((h, w), np.uint8), np.empty((h // 2, w // 2), np.uint8),
           np.empty((h // 2, w // 2), np.uint8))
    _native()[0].hi3d_h264_rgb_to_yuv420(rgb.ctypes.data, w, h, *(p.ctypes.data for p in out))
    return out


def to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB of cropped planes (the inverse BT.601 matrix in C)."""
    h, w = y.shape
    if u.shape != (h // 2, w // 2) or v.shape != u.shape or h % 2 or w % 2:
        raise ValueError(f"planes {y.shape}, {u.shape}, {v.shape} are not 4:2:0 of even size")
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    out = np.empty((h, w, 3), np.uint8)
    rc = _native()[1].hi3d_h264_yuv_to_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h,
                                           w, w // 2, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"yuv_to_rgb failed ({rc})")
    return out
