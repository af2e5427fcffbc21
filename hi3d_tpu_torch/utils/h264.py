"""H.264 video without cv2 or imageio: the encoder the port writes its
mp4s with, and a decoder for the streams it writes (the JAX package writes
through imageio's ffmpeg or cv2, hi3d_tpu/utils/video.py:84-127, and reads
back through them, :130-156).

The stream (`encode`): Constrained Baseline (profile_idc 66,
constraint_set0/1), `level_idc` from the frame size and rate (Table A-1);
one SPS and one PPS; the first picture an IDR I picture, every later one a
P picture (nal_ref_idc 3) that predicts from the previous decoded picture
(`max_num_ref_frames` 1, the sliding window), `frame_num` counting modulo
16; CAVLC; I macroblocks Intra16x16, Intra4x4 or I_PCM, P macroblocks
P_Skip, 16x16, 16x8, 8x16, P_8x8 (8x8 sub-macroblocks) or intra, with
quarter-sample motion (csrc/h264_encode.c); the deblocking filter on as
libx264's default (`disable_deblocking_filter_idc` 0, offsets 0); each
picture cut into slices of 4 macroblock rows (8 at 512², 16 at 1024²),
which encode in parallel host threads, so the stream is a function of the
frames, QP and rate alone; frame cropping for even sizes that are not
whole macroblocks; a VUI with BT.601 primaries, transfer and matrix (6)
and limited range, the frame rate, and no reordering.

Colour: RGB -> Y'CbCr BT.601 limited range, the integer formula at the top
of csrc/h264_encode.c (chroma the rounded mean of each 2x2, swscale's
default matrix, which ffmpeg's decoders invert); `to_rgb` inverts it with
the integer formula of csrc/h264_decode.c.

Quality: JAX's `quality` (0-10) becomes the QP as imageio-ffmpeg turns it
into libx264's CRF, int((1 - quality / 10) * 51): 5 at the default 9, the
same for I and P pictures.

The decoder (`decode`) reads I and P slices (Baseline CAVLC): IDR or not,
one or more a picture, mb_skip_run, the P partitions and sub-partitions,
refIdxL0 with up to 16 active references, the short-term sliding window,
intra and I_PCM macroblocks in P slices, the deblocking filter with its
three `disable_deblocking_filter_idc` values and offsets, cropping and
pic_order_cnt_type 0 or 2, in decoding order (no B slices, so no
reordering). Parameter sets and slice headers are parsed here; every field
that sizes or indexes something is checked here and again in C. A stream
outside that subset (CABAC, B/SP/SI slices, weighted prediction, long-term
references or adaptive marking, reference list modification, gaps in
frame_num, a profile above Baseline, interlace, the 8x8 transform, ...)
raises `Unsupported`, a ValueError that names what it found; a damaged one
raises a ValueError that names where.
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


# What the encoder and decoder count, in the order of csrc/h264_common.h's
# ST_* (qpel_XY: luma partitions interpolated at quarter position (X, Y)).
STATS = ("skip", "skip_run_end", "skip_run_wrap", "p16x16", "p16x8", "p8x16", "p8x8", "p8x8ref0",
         "sub8x8", "sub8x4", "sub4x8", "sub4x4", "intra_in_p", "i4x4", "i16x16", "pcm",
         "ref_idx_nonzero", "ref_idx_bit", "ref_idx_ue", "mv_outside", "chroma_frac",
         "bs1", "bs2", "bs3", "bs4", "slice_edge_filtered",
         *(f"qpel_{x}{y}" for y in range(4) for x in range(4)))

# SliceParams.partition of the encoder: the forced macroblock choices of
# encode's `partition`
PARTITIONS = {"16x16": 0, "16x8": 1, "8x16": 2, "8x8": 3, "8x8ref0": 4, "8x4": 5, "4x8": 6,
              "4x4": 7, "mixed": 8, "intra": 9, "pcm": 10}
_SKIP = 11  # every macroblock P_Skip: a frame that repeats the one before it
PICTURES = ("idr", "i", "p")


class _SliceParams(ctypes.Structure):
    """csrc/h264_encode.c's SliceParams"""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "mb_w", "mb_h", "first_row", "rows", "slice_num", "qp", "nal_type", "slice_type",
        "idr_pic_id", "frame_num", "poc_type", "poc_lsb", "nref", "filter_idc", "filter_a_div2",
        "filter_b_div2", "partition", "mv_range_y")]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _native() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            enc = cbuild.load("h264_encode.c", "hi3d_h264enc", "h264.encode")
            enc.hi3d_h264_encode_slice.argtypes = [p, p, p, p, p, p, p, p, p, p, p, l, p, p]
            enc.hi3d_h264_encode_slice.restype = i
            enc.hi3d_h264_source_planes.argtypes = [p, i, i, p, p, p]
            enc.hi3d_h264_source_planes.restype = i
            enc.hi3d_h264_rgb_to_yuv420.argtypes = [p, i, i, p, p, p]
            enc.hi3d_h264_rgb_to_yuv420.restype = i
            dec = cbuild.load("h264_decode.c", "hi3d_h264dec", "h264.decode")
            dec.hi3d_h264_decode_slice.argtypes = [p, l, l, *[i] * 11, p, p, i, *[p] * 8, i]
            dec.hi3d_h264_decode_slice.restype = i
            dec.hi3d_h264_yuv_to_rgb.argtypes = [p, p, p, i, i, i, i, p]
            dec.hi3d_h264_yuv_to_rgb.restype = i
            dec.hi3d_h264_deblock.argtypes = [p, p, p, i, i, p, i, p]  # both sides' filter
            dec.hi3d_h264_deblock.restype = i
            dec.hi3d_h264_mbinfo_size.restype = i
            _lib = (enc, dec)
    return _lib


def _counts_to(stats: Optional[dict], counts: np.ndarray) -> None:
    if stats is not None:
        for key, n in zip(STATS, counts.tolist()):
            stats[key] = stats.get(key, 0) + n


def quality_to_qp(quality: float) -> int:
    """imageio-ffmpeg's quality -> libx264 CRF mapping, as the QP."""
    if not 0 <= quality <= 10:
        raise ValueError(f"quality {quality} outside 0..10")
    return int((1 - quality / 10) * 51)


def mv_range_y(level: int) -> int:
    """The vertical vector range of a level (Table A-1, MaxVmvR) in quarter
    samples: vectors lie in [-range, range)."""
    return 256 if level <= 10 else 512 if level <= 20 else 1024 if level <= 30 else 2048


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

def write_sps(width: int, height: int, fps: int, poc_type: int = 2, refs: int = 1) -> bytes:
    """The SPS NAL unit (with its header byte) of the encoder's streams,
    `refs` reference frames (and as many frames of decoded picture
    buffer)."""
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
    w.ue(refs)  # max_num_ref_frames
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
    w.ue(refs)  # max_dec_frame_buffering
    return b"\x67" + escape(w.rbsp())


def write_pps(qp: int) -> bytes:
    """The PPS NAL unit of the encoder's streams: CAVLC, QP `qp`, one active
    reference unless a slice says more, the loop filter's control present
    (each slice sets it)."""
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
    max_refs: int = 1  # max_num_ref_frames

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
    nref: int = 1  # num_ref_idx_l0_default_active_minus1 + 1
    weighted_pred: bool = False
    constrained_intra: bool = False


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
    max_refs = _ranged(r.ue(), 0, 16, f"{where}: max_num_ref_frames")
    r.u(1)  # gaps_in_frame_num_value_allowed_flag: a gap is refused either way
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
    return SPS(sps_id, log2_frame_num, poc_type, log2_poc, mb_w, mb_h, crop, max_refs)


def parse_pps(nal: bytes, where: str) -> PPS:
    r = _BitReader(unescape(nal[1:]), f"{where}: PPS")
    pps_id = _ranged(r.ue(), 0, 255, f"{where}: pic_parameter_set_id")
    sps_id = _ranged(r.ue(), 0, 31, f"{where}: seq_parameter_set_id")
    if r.u(1):
        raise Unsupported(f"{where}: CABAC (entropy_coding_mode_flag 1); only CAVLC decodes here")
    bottom = bool(r.u(1))
    if r.ue():
        raise Unsupported(f"{where}: slice groups (num_slice_groups_minus1 > 0)")
    nref = _ranged(r.ue(), 0, 31, f"{where}: num_ref_idx_l0_default_active_minus1") + 1
    r.ue()  # num_ref_idx_l1_default_active_minus1: B slices are refused
    weighted = bool(r.u(1))
    r.u(2)  # weighted_bipred_idc: B slices are refused
    qp = 26 + _ranged(r.se(), -26, 25, f"{where}: pic_init_qp_minus26")
    r.se()
    cqp = _ranged(r.se(), -12, 12, f"{where}: chroma_qp_index_offset")
    deblocking = bool(r.u(1))
    constrained_intra = bool(r.u(1))
    if r.u(1):
        raise Unsupported(f"{where}: redundant pictures (redundant_pic_cnt_present_flag 1)")
    if r.more_data():
        if r.u(1):
            raise Unsupported(f"{where}: the 8x8 transform (transform_8x8_mode_flag 1)")
        if r.u(1):
            raise Unsupported(f"{where}: scaling matrices (pic_scaling_matrix_present_flag 1)")
    return PPS(pps_id, sps_id, bottom, qp, cqp, deblocking, nref, weighted, constrained_intra)


SLICE_TYPES = {0: "P", 1: "B", 2: "I", 3: "SP", 4: "SI"}


@dataclass
class Slice:
    """A parsed slice header and its RBSP (slice_type 0 P, 2 I; filter_a/b
    are FilterOffsetA/B; nref is num_ref_idx_l0_active)."""

    rbsp: bytes
    sps: SPS
    pps: PPS
    nal_type: int
    ref_idc: int
    first_mb: int
    slice_type: int
    frame_num: int
    nref: int
    qp: int
    filter_idc: int
    filter_a: int
    filter_b: int
    bitpos: int


def _slice_header(rbsp: bytes, nal_type: int, ref_idc: int, sps: Dict[int, SPS],
                  pps: Dict[int, PPS], where: str) -> Slice:
    r = _BitReader(rbsp, f"{where}: slice header")
    first_mb = r.ue()
    slice_type = _ranged(r.ue(), 0, 9, f"{where}: slice_type") % 5
    if slice_type not in (0, 2):
        raise Unsupported(f"{where}: a {SLICE_TYPES[slice_type]} slice; only I and P slices "
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
    frame_num = r.u(s.log2_max_frame_num)
    if nal_type == 5:
        if slice_type != 2:
            raise ValueError(f"{where}: a P slice in an IDR picture")
        r.ue()  # idr_pic_id
    if s.poc_type == 0:
        r.u(s.log2_max_poc_lsb)
        if p.bottom_field_poc:
            r.se()
    nref = 0
    if slice_type == 0:
        if p.weighted_pred:
            raise Unsupported(f"{where}: weighted prediction (weighted_pred_flag 1) in a P slice")
        if p.constrained_intra:
            raise Unsupported(f"{where}: constrained intra prediction (constrained_intra_pred_flag "
                              "1) in a P slice")
        nref = p.nref
        if r.u(1):  # num_ref_idx_active_override_flag
            nref = r.ue() + 1
        _ranged(nref - 1, 0, 15, f"{where}: num_ref_idx_l0_active_minus1")
        if r.u(1):
            raise Unsupported(f"{where}: reference picture list modification "
                              "(ref_pic_list_modification_flag_l0 1)")
    if ref_idc:
        if nal_type == 5:
            r.u(1)  # no_output_of_prior_pics_flag
            if r.u(1):
                raise Unsupported(f"{where}: a long-term reference (long_term_reference_flag 1)")
        elif r.u(1):
            raise Unsupported(f"{where}: adaptive reference picture marking (MMCO, "
                              "adaptive_ref_pic_marking_mode_flag 1)")
    qp = p.qp + r.se()
    if not 0 <= qp <= 51:
        raise ValueError(f"{where}: slice QP {qp} outside 0..51")
    idc = 0
    if p.deblocking_control:
        idc = _ranged(r.ue(), 0, 2, f"{where}: disable_deblocking_filter_idc")
    fa = fb = 0
    if idc != 1 and p.deblocking_control:
        fa = 2 * _ranged(r.se(), -6, 6, f"{where}: slice_alpha_c0_offset_div2")
        fb = 2 * _ranged(r.se(), -6, 6, f"{where}: slice_beta_offset_div2")
    return Slice(rbsp, s, p, nal_type, ref_idc, first_mb, slice_type, frame_num, nref, qp, idc,
                 fa, fb, r.pos)


# --------------------------------------------------------------- encoding

@dataclass
class Encoded:
    """An encoded clip: the parameter sets, one MP4 sample a picture
    (4-byte length-prefixed NAL units), the indices of its IDR samples (the
    mp4's sync samples) and the encoder's reconstruction (the decoded
    pictures, filtered), as cropped Y, Cb, Cr planes a picture."""

    sps: bytes
    pps: bytes
    samples: List[bytes]
    recon: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    sync: List[int]


def _threads(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 1))


def encode(frames: Sequence[np.ndarray], qp: int, fps: int, *, slice_rows: int = 4,
           pictures: str = "p", refs: int = 1, partition: Optional[str] = None,
           filter_idc: int = 0, filter_offsets: Tuple[int, int] = (0, 0), poc_type: int = 2,
           threads: Optional[int] = None, stats: Optional[dict] = None) -> Encoded:
    """Encodes (H, W, 3) uint8 RGB frames of one even size at `qp`: the
    pictures in order, the slices of each (`slice_rows` macroblock rows
    each; 0: one slice a picture) in parallel host threads (`threads`,
    default one a slice up to the CPU count; the stream does not depend on
    it). The other keywords give the decoder streams it must read:
    `pictures` "p" (IDR, then P pictures; a frame equal to the one before
    it is all P_Skip, so it decodes as a copy), "i" (IDR, then non-IDR I
    pictures) or "idr" (every picture IDR); `refs` the reference pictures a
    P picture may use (1-16); `partition` forces every macroblock of a P
    picture to one of PARTITIONS; `filter_idc` and `filter_offsets`
    (slice_alpha_c0_offset_div2, slice_beta_offset_div2) set the loop
    filter; `poc_type` 0 writes POC lsbs. When given, `stats` receives the
    count of each of STATS and of "IDR", "I" and "P" pictures."""
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
    if pictures not in PICTURES or not 1 <= refs <= 16 or filter_idc not in (0, 1, 2):
        raise ValueError(f"pictures {pictures!r} (one of {PICTURES}), refs {refs} (1..16), "
                         f"filter_idc {filter_idc} (0..2)")
    if partition is not None and partition not in PARTITIONS:
        raise ValueError(f"partition {partition!r} is none of {sorted(PARTITIONS)}")
    if partition == "8x8ref0" and refs < 2:
        raise ValueError("P_8x8ref0 needs refs >= 2")
    if not all(-6 <= o <= 6 for o in filter_offsets):
        raise ValueError(f"filter offsets {filter_offsets} outside -6..6")
    sps, pps = write_sps(w, h, fps, poc_type, refs), write_pps(qp)
    mb_w, mb_h = -(-w // 16), -(-h // 16)
    rows = slice_rows if slice_rows > 0 else mb_h
    starts = list(range(0, mb_h, rows))
    cap = rows * mb_w * 600 + 1024
    enc, dec = _native()
    mb_bytes = dec.hi3d_h264_mbinfo_size()
    src = (np.empty((mb_h * 16, mb_w * 16), np.uint8), np.empty((mb_h * 8, mb_w * 8), np.uint8),
           np.empty((mb_h * 8, mb_w * 8), np.uint8))
    vmv = mv_range_y(level_idc(w, h, fps))
    counts = np.zeros((len(starts), len(STATS)), np.int64)
    dpb: List[Tuple[Tuple[np.ndarray, ...], int]] = []  # (planes, picture id), most recent first
    samples, recon, sync = [], [], []
    with ThreadPoolExecutor(threads or _threads(len(starts))) as pool:
        for i, frame in enumerate(frames):
            idr = i == 0 or pictures == "idr"
            p_pic = not idr and pictures == "p"
            force = PARTITIONS[partition] if partition else -1
            if p_pic and force < 0 and np.array_equal(frame, frames[i - 1]):
                force = _SKIP  # decodes as a copy of the picture before
            enc.hi3d_h264_source_planes(frame.ctypes.data, w, h, *(x.ctypes.data for x in src))
            rec = tuple(np.empty_like(x) for x in src)
            mbinfo = np.zeros(mb_w * mb_h * mb_bytes, np.uint8)
            active = dpb[:refs] if p_pic else []
            ref_ptrs = (ctypes.c_void_p * max(1, 3 * len(active)))(
                *[x.ctypes.data for planes, _ in active for x in planes])
            ref_ids = np.array([pid for _, pid in active] or [0], np.int32)

            def one(k: int):
                sp = _SliceParams(mb_w, mb_h, starts[k], rows, k, qp, 5 if idr else 1,
                                  0 if p_pic else 2, i % 2 if idr else 0, 0 if idr else i % 16,
                                  poc_type, (2 * i) % 256, len(active), filter_idc,
                                  filter_offsets[0], filter_offsets[1],
                                  force, vmv)
                out = np.empty(cap, np.uint8)
                n = ctypes.c_long(0)
                rc = enc.hi3d_h264_encode_slice(
                    ctypes.byref(sp), *(x.ctypes.data for x in src), ref_ptrs,
                    ref_ids.ctypes.data, *(x.ctypes.data for x in rec), mbinfo.ctypes.data,
                    out.ctypes.data, cap, ctypes.byref(n), counts[k].ctypes.data)
                if rc != 0:
                    raise RuntimeError(f"h264 encode of frame {i}, slice {k} failed ({rc})")
                return out[:n.value].tobytes()

            nals = list(pool.map(one, range(len(starts))))
            dec.hi3d_h264_deblock(*(x.ctypes.data for x in rec), mb_w, mb_h, mbinfo.ctypes.data, 0,
                                  counts[0].ctypes.data)
            samples.append(b"".join(nals))
            recon.append((rec[0][:h, :w], rec[1][:h // 2, :w // 2], rec[2][:h // 2, :w // 2]))
            if idr:
                sync.append(i)
            dpb = [(rec, i)] + (dpb[:refs - 1] if not idr else [])
            if stats is not None:
                kind = "IDR" if idr else "P" if p_pic else "I"
                stats[kind] = stats.get(kind, 0) + 1
    _counts_to(stats, counts.sum(0))
    return Encoded(sps, pps, samples, recon, sync)


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


@dataclass
class _Picture:
    """A picture's slices, the earlier pictures (by index) each slice's
    RefPicList0 holds, and where it is in the stream."""

    slices: List[Slice]
    lists: List[List[int]]
    where: str


class Decoder:
    """Decodes pictures of one stream; the parameter sets come from the
    container (`avcC`) and may be replaced in-band. `plan` follows the
    reference marking in decoding order (the sliding window of 8.2.5.3)."""

    def __init__(self, sps_nals: Sequence[bytes], pps_nals: Sequence[bytes], name: str):
        self.name = name
        self.sps: Dict[int, SPS] = {}
        self.pps: Dict[int, PPS] = {}
        for nal in sps_nals:
            self._param_set(nal, f"{name}: avcC")
        for nal in pps_nals:
            self._param_set(nal, f"{name}: avcC")
        self.size: Optional[Tuple[int, int]] = None
        self.refs: List[Tuple[int, int]] = []  # (FrameNum, picture index) of the short-term refs
        self.prev_ref_frame_num: Optional[int] = None
        self.count = 0

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

    def slices(self, nals: Sequence[bytes], where: str) -> List[Slice]:
        """Parses the picture's NAL units in order (parameter sets update the
        decoder); returns its slices."""
        out = []
        for nal in nals:
            if nal[0] & 0x80:
                raise ValueError(f"{where}: forbidden_zero_bit set")
            kind, ref_idc = nal[0] & 31, nal[0] >> 5
            if kind in (7, 8):
                self._param_set(nal, where)
            elif kind in (1, 5):
                out.append(_slice_header(unescape(nal[1:]), kind, ref_idc, self.sps, self.pps,
                                         where))
            elif kind in (2, 3, 4):
                raise Unsupported(f"{where}: data partitioning (NAL unit type {kind}); only "
                                  "whole slices decode here")
            elif kind in (14, 15, 20, 21):
                raise Unsupported(f"{where}: an SVC/MVC NAL unit (type {kind})")
            # 6 SEI, 9 access unit delimiter, 10-12 ends and filler, ...: nothing to decode
        if not out:
            raise ValueError(f"{where}: no slice")
        return out

    def plan(self, slices: List[Slice], where: str) -> _Picture:
        """Checks that the slices make one picture that follows the ones
        before it, returns each slice's RefPicList0 (descending PicNum, with
        FrameNumWrap across the frame_num wrap) and marks the picture."""
        first = slices[0]
        for x in slices[1:]:
            if (x.sps is not first.sps or x.frame_num != first.frame_num
                    or x.nal_type != first.nal_type or bool(x.ref_idc) != bool(first.ref_idc)):
                raise ValueError(f"{where}: slices of one picture differ in SPS, frame_num, IDR or "
                                 "nal_ref_idc")
            if x.pps.cqp_offset != first.pps.cqp_offset:
                raise Unsupported(f"{where}: slices of one picture with two "
                                  "chroma_qp_index_offsets")
        max_fn = 1 << first.sps.log2_max_frame_num
        fn = first.frame_num
        if first.nal_type == 5:
            if fn:
                raise ValueError(f"{where}: an IDR picture with frame_num {fn}")
            self.refs = []
        elif self.prev_ref_frame_num is not None and fn != (self.prev_ref_frame_num + 1) % max_fn:
            if fn == self.prev_ref_frame_num:
                raise ValueError(f"{where}: frame_num {fn} repeats the previous reference "
                                 "picture's")
            raise Unsupported(f"{where}: a gap in frame_num ({fn} after "
                              f"{self.prev_ref_frame_num})")

        def wrap(ref):  # FrameNumWrap, which is PicNum for frames
            return ref[0] if ref[0] <= fn else ref[0] - max_fn

        ordered = sorted(self.refs, key=wrap, reverse=True)
        lists = []
        for x in slices:
            if x.slice_type == 0 and not ordered:
                raise ValueError(f"{where}: a P slice with no reference picture before it")
            lists.append([idx for _, idx in ordered[:x.nref]] if x.slice_type == 0 else [])
        if first.ref_idc:
            if len(self.refs) >= max(first.sps.max_refs, 1):  # the sliding window
                self.refs.remove(min(self.refs, key=wrap))
            self.refs.append((fn, self.count))
            self.prev_ref_frame_num = fn
        self.count += 1
        return _Picture(slices, lists, where)

    def picture(self, pic: _Picture, done: Sequence[Tuple[np.ndarray, ...]], counts: np.ndarray,
                pool: Optional[ThreadPoolExecutor] = None) -> Tuple[np.ndarray, ...]:
        """Decodes one picture (its slices in parallel on `pool` when their
        first macroblocks rise) from the filtered planes of the pictures in
        `done`; returns its filtered planes of the coded size. counts: one
        row of STATS a slice, and one more for the filter."""
        dec = _native()[1]
        s, where = pic.slices[0].sps, pic.where
        planes = (np.zeros((s.mb_h * 16, s.mb_w * 16), np.uint8),
                  np.zeros((s.mb_h * 8, s.mb_w * 8), np.uint8),
                  np.zeros((s.mb_h * 8, s.mb_w * 8), np.uint8))
        total = s.mb_w * s.mb_h
        mbinfo = np.zeros(total * dec.hi3d_h264_mbinfo_size(), np.uint8)
        owner = np.full(total, -1, np.int32)
        firsts = [x.first_mb for x in pic.slices]
        rising = all(a < b for a, b in zip(firsts, firsts[1:]))
        limits = firsts[1:] + [total] if rising else [total] * len(firsts)

        def one(k: int) -> None:
            x, refs = pic.slices[k], pic.lists[k]
            buf = np.frombuffer(x.rbsp, np.uint8)
            if buf.size == 0:
                raise ValueError(f"{where}: an empty slice")
            ptrs = (ctypes.c_void_p * max(1, 3 * x.nref))(
                *[p.ctypes.data for i in refs for p in done[i]])
            ids = np.array(refs + [-1] * (x.nref - len(refs)) or [0], np.int32)
            msg = ctypes.create_string_buffer(160)
            end = ctypes.c_int(0)
            rc = dec.hi3d_h264_decode_slice(
                buf.ctypes.data, buf.size, x.bitpos, s.mb_w, s.mb_h, x.first_mb, limits[k],
                x.slice_type, x.qp, x.pps.cqp_offset, x.filter_idc, x.filter_a, x.filter_b,
                x.nref, ptrs, ids.ctypes.data, k, owner.ctypes.data, mbinfo.ctypes.data,
                *(p.ctypes.data for p in planes), counts[k].ctypes.data, ctypes.byref(end), msg,
                len(msg))
            if rc == -2:
                raise MemoryError(f"{where}: out of memory")
            if rc != 0:
                raise ValueError(f"{where}: slice {k}: {msg.value.decode() or f'error {rc}'}")

        if pool is not None and rising and len(firsts) > 1:
            list(pool.map(one, range(len(firsts))))
        else:
            for k in range(len(firsts)):
                one(k)
        missing = int((owner < 0).sum())
        if missing:
            raise ValueError(f"{where}: the slices leave {missing} of {owner.size} macroblocks "
                             "undecoded")
        dec.hi3d_h264_deblock(*(p.ctypes.data for p in planes), s.mb_w, s.mb_h, mbinfo.ctypes.data,
                              pic.slices[0].pps.cqp_offset, counts[-1].ctypes.data)
        return planes


def decode(sps_nals: Sequence[bytes], pps_nals: Sequence[bytes], samples: Sequence[bytes],
           length_size: int = 4, name: str = "h264",
           stats: Optional[dict] = None) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(Y, Cb, Cr) of every sample (one picture each, in decoding order).
    Headers are parsed in order (in-band parameter sets apply to the
    samples after them). A stream with P slices decodes picture after
    picture, the slices of each in parallel host threads; a stream of intra
    pictures only decodes its pictures in parallel. When given, `stats`
    receives the count of each of STATS and of "IDR", "I" and "P"
    pictures."""
    d = Decoder(sps_nals, pps_nals, name)
    pics = []
    for i, sample in enumerate(samples):
        where = f"{name}: sample {i}"
        sl = d.slices(split_sample(sample, length_size, where), where)
        size = sl[0].sps.size
        if d.size is None:
            d.size = size
        elif size != d.size:
            raise ValueError(f"{where}: picture size {size} after {d.size}")
        if size[0] % 2 or size[1] % 2:
            raise ValueError(f"{where}: a cropped size {size} with an odd side")
        pics.append(d.plan(sl, where))
        if stats is not None:
            p_slices = any(x.slice_type == 0 for x in sl)
            kind = "IDR" if sl[0].nal_type == 5 else "P" if p_slices else "I"
            stats[kind] = stats.get(kind, 0) + 1
    counts = [np.zeros((len(p.slices) + 1, len(STATS)), np.int64) for p in pics]
    inter = any(p.lists[k] for p in pics for k in range(len(p.slices)))
    if inter:
        done: List[Tuple[np.ndarray, ...]] = []
        with ThreadPoolExecutor(_threads(max(len(p.slices) for p in pics))) as pool:
            for p, c in zip(pics, counts):
                done.append(d.picture(p, done, c, pool))
    else:
        with ThreadPoolExecutor(_threads(len(pics))) as pool:
            done = list(pool.map(lambda a: d.picture(a[0], [], a[1]), zip(pics, counts)))
    _counts_to(stats, sum(c.sum(0) for c in counts))
    out = []
    for p, planes in zip(pics, done):
        l, r, t, b = p.slices[0].sps.crop
        w, h = p.slices[0].sps.size
        chroma = (slice(t // 2, (t + h) // 2), slice(l // 2, (l + w) // 2))
        out.append((planes[0][t:t + h, l:l + w], planes[1][chroma], planes[2][chroma]))
    return out


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
