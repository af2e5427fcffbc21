"""ISO BMFF (MP4) muxer and demuxer of one H.264 video track (the port's
mp4 output and input; the JAX package goes through imageio's ffmpeg or cv2,
hi3d_tpu/utils/video.py:84-156).

`write_mp4` writes `ftyp` (isom, avc1), then `moov` before `mdat` (fast
start): `mvhd`, and a `trak` of `tkhd`, `mdia` (`mdhd`, `hdlr vide`,
`minf` with `vmhd`, `dinf`, and `stbl`: `stsd` holding `avc1` with its
`avcC` and a `colr` nclx box of BT.601 limited range, `stts` at the clip's
rate, `stsz`, `stsc` and `stco`, or `co64` when an offset passes 4 GiB).
One sample a chunk; an `stss` box lists the sync samples (the IDR
pictures) where some samples are not (the P pictures).

`read_mp4` finds `moov` before or after `mdat`, skips unknown and `free`
boxes, and returns the first video track's codec, its decoder
configuration, its samples and its sync samples (`stss`, where present):
for `avc1`/`avc3` the `avcC` parameter sets, for `mp4v` (cv2's
VideoWriter) the `esds` DecoderSpecificInfo of an MPEG-4 Visual stream
(objectTypeIndication 0x20; utils/mpeg4.py decodes it). A malformed or
truncated file raises a ValueError that names the box; any other sample
entry (HEVC, AV1, ...) or an `mp4v` entry that carries another codec
(MPEG-1/2 video, JPEG, ...) raises `h264.Unsupported`.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .h264 import Unsupported

MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
TIMESCALE_PER_FRAME = 1000  # media ticks a frame: the media timescale is 1000 · fps


def box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def avcc(sps: bytes, pps: bytes) -> bytes:
    """AVCDecoderConfigurationRecord with 4-byte NAL lengths."""
    return (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + struct.pack(">H", len(sps)) + sps
            + bytes([1]) + struct.pack(">H", len(pps)) + pps)


def _moov(sps: bytes, pps: bytes, width: int, height: int, fps: int, sizes: Sequence[int],
          offsets: Sequence[int], sync: Optional[Sequence[int]] = None) -> bytes:
    n = len(sizes)
    timescale, delta = fps * TIMESCALE_PER_FRAME, TIMESCALE_PER_FRAME
    movie_ms = n * 1000 // fps
    avc1 = box(b"avc1", bytes(6), struct.pack(">H", 1), bytes(16),
               struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1),
               bytes([8]) + b"hi3d h264".ljust(31, b"\0"), struct.pack(">Hh", 0x18, -1),
               box(b"avcC", avcc(sps, pps)),
               box(b"colr", b"nclx", struct.pack(">HHHB", 6, 6, 6, 0)))
    wide = offsets and offsets[-1] > 0xFFFFFFFF
    chunk_offsets = (full_box(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *offsets)) if wide else
                     full_box(b"stco", 0, 0, struct.pack(f">I{n}I", n, *offsets)))
    stbl = box(b"stbl",
               full_box(b"stsd", 0, 0, struct.pack(">I", 1), avc1),
               full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
               full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
               full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
               chunk_offsets,
               *([] if sync is None or len(sync) == n else
                 [full_box(b"stss", 0, 0, struct.pack(f">I{len(sync)}I", len(sync),
                                                      *(i + 1 for i in sync)))]))
    minf = box(b"minf", full_box(b"vmhd", 0, 1, bytes(8)),
               box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1), full_box(b"url ", 0, 1))),
               stbl)
    mdia = box(b"mdia",
               full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, timescale, n * delta),
                        struct.pack(">HH", 0x55C4, 0)),  # language "und"
               full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0"),
               minf)
    tkhd = full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), bytes(8),
                    struct.pack(">hhhH", 0, 0, 0, 0), MATRIX,
                    struct.pack(">II", width << 16, height << 16))
    mvhd = full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie_ms),
                    struct.pack(">IH", 0x10000, 0x100), bytes(10), MATRIX, bytes(24),
                    struct.pack(">I", 2))
    return box(b"moov", mvhd, box(b"trak", tkhd, mdia))


def write_mp4(path: str, sps: bytes, pps: bytes, samples: Sequence[bytes], width: int,
              height: int, fps: int, sync: Optional[Sequence[int]] = None) -> int:
    """Writes the clip (samples: 4-byte length-prefixed NAL units, one
    picture each; `sync` the indices of the sync samples, all when None) to
    `path` through a temporary file renamed into place; returns the bytes
    written."""
    if not samples:
        raise ValueError("an mp4 needs at least one sample")
    if sync is not None and (list(sync) != sorted(set(sync)) or not sync or sync[0] != 0
                             or sync[-1] >= len(samples)):
        raise ValueError(f"sync samples {list(sync)[:8]} must rise from 0 within the "
                         f"{len(samples)} samples")
    if not isinstance(fps, int) or fps < 1:
        raise ValueError(f"fps must be a positive int; got {fps!r}")
    ftyp = box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2avc1mp41")
    sizes = [len(s) for s in samples]
    data = sum(sizes)
    mdat_head = 16 if data + 8 > 0xFFFFFFFF else 8
    # the moov's size depends on stco against co64, which depends on the offsets
    moov = b""
    for _ in range(2):
        offsets = [len(ftyp) + len(moov) + mdat_head]
        for size in sizes[:-1]:
            offsets.append(offsets[-1] + size)
        moov = _moov(sps, pps, width, height, fps, sizes, offsets, sync)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(ftyp)
            f.write(moov)
            if mdat_head == 16:
                f.write(struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", 16 + data))
            else:
                f.write(struct.pack(">I", 8 + data) + b"mdat")
            for s in samples:
                f.write(s)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return len(ftyp) + len(moov) + mdat_head + data


# ------------------------------------------------------------------ reading

@dataclass
class Track:
    """The first video track: its `avcC` parameter sets and NAL length
    size (H.264), the samples, their width and height, the frame rate, the
    sample entry's codec ("avc1", "avc3" or "mp4v"), for "mp4v" the `esds`
    DecoderSpecificInfo (the VOS, VO and VOL headers), and the indices of
    the sync samples (`stss`; None where the box is absent: every sample)."""

    sps: List[bytes]
    pps: List[bytes]
    length_size: int
    samples: List[bytes]
    width: int
    height: int
    fps: float
    codec: str = "avc1"
    config: bytes = b""
    sync: Optional[List[int]] = None


class _Boxes:
    """Iterates over the boxes of data[start:end]."""

    def __init__(self, data: memoryview, start: int, end: int, where: str):
        self.data, self.pos, self.end, self.where = data, start, end, where

    def __iter__(self):
        while self.pos < self.end:
            if self.pos + 8 > self.end:
                raise ValueError(f"{self.where}: a box header cut at byte {self.pos}")
            size, kind = struct.unpack_from(">I4s", self.data, self.pos)
            head = 8
            if size == 1:
                if self.pos + 16 > self.end:
                    raise ValueError(f"{self.where}: a box header cut at byte {self.pos}")
                size = struct.unpack_from(">Q", self.data, self.pos + 8)[0]
                head = 16
            elif size == 0:
                size = self.end - self.pos
            name = kind.decode("latin-1")
            if size < head or self.pos + size > self.end:
                raise ValueError(f"{self.where}/{name}: box of {size} bytes at byte {self.pos} "
                                 f"runs past its parent's {self.end - self.pos}")
            yield name, self.pos + head, self.pos + size
            self.pos += size


def _children(data, start, end, where) -> Dict[str, Tuple[int, int]]:
    out: Dict[str, Tuple[int, int]] = {}
    for name, a, b in _Boxes(data, start, end, where):
        out.setdefault(name, (a, b))
    return out


def _need(d: Dict[str, Tuple[int, int]], name: str, where: str) -> Tuple[int, int]:
    if name not in d:
        raise ValueError(f"{where}: no '{name}' box")
    return d[name]


def _unpack(fmt: str, data, a: int, b: int, where: str):
    if a + struct.calcsize(fmt) > b:
        raise ValueError(f"{where}: truncated")
    return struct.unpack_from(fmt, data, a)


def _table(fmt: str, data, a: int, b: int, where: str) -> list:
    """A full box's entry count at a + 4, then that many `fmt` entries."""
    (n,) = _unpack(">I", data, a + 4, b, where)
    size = struct.calcsize(">" + fmt)
    if a + 8 + n * size > b:
        raise ValueError(f"{where}: {n} entries of {size} bytes in {b - a - 8}")
    rows = struct.iter_unpack(">" + fmt, data[a + 8:a + 8 + n * size])
    return [r[0] if len(r) == 1 else r for r in rows]


def _parse_avcc(data, a: int, b: int, where: str):
    if b - a < 7 or data[a] != 1:
        raise ValueError(f"{where}: not an AVCDecoderConfigurationRecord (version "
                         f"{data[a] if b > a else None})")
    length_size = (data[a + 4] & 3) + 1
    if length_size == 3:
        raise ValueError(f"{where}: NAL length size 3")
    pos, sets = a + 5, []
    for mask in (0x1F, 0xFF):
        if pos >= b:
            raise ValueError(f"{where}: truncated")
        n = data[pos] & mask
        pos += 1
        group = []
        for _ in range(n):
            (size,) = _unpack(">H", data, pos, b, where)
            if pos + 2 + size > b or size == 0:
                raise ValueError(f"{where}: a parameter set of {size} bytes runs past the box")
            group.append(bytes(data[pos + 2:pos + 2 + size]))
            pos += 2 + size
        sets.append(group)
    return sets[0], sets[1], length_size


def read_mp4(path: str) -> Track:
    """The first video track of the mp4 at `path`."""
    name = os.path.basename(path)
    with open(path, "rb") as f:
        raw = f.read()
    data = memoryview(raw)
    top = _children(data, 0, len(raw), name)
    if "ftyp" not in top and "moov" not in top:
        raise ValueError(f"{name}: not an ISO BMFF file (no ftyp or moov box)")
    moov = _need(top, "moov", name)
    where = f"{name}/moov"
    traks = [(a, b) for kind, a, b in _Boxes(data, *moov, where) if kind == "trak"]
    for ta, tb in traks:
        tw = f"{where}/trak"
        mdia = _need(_children(data, ta, tb, tw), "mdia", tw)
        mw = f"{tw}/mdia"
        kids = _children(data, *mdia, mw)
        ha, hb = _need(kids, "hdlr", mw)
        if bytes(_unpack(">8x4s", data, ha, hb, f"{mw}/hdlr")[0]) != b"vide":
            continue
        ma, mb = _need(kids, "mdhd", mw)
        version = data[ma] if ma < mb else 0
        (timescale,) = _unpack(">8xI" if version == 0 else ">16xI", data, ma + 4, mb,
                               f"{mw}/mdhd")
        minf = _need(kids, "minf", mw)
        stbl = _need(_children(data, *minf, f"{mw}/minf"), "stbl", f"{mw}/minf")
        sw = f"{mw}/minf/stbl"
        return _read_track(data, _children(data, *stbl, sw), sw, timescale, len(raw))
    raise ValueError(f"{where}: no video track")


def _read_track(data, st: Dict[str, Tuple[int, int]], sw: str, timescale: int,
                file_size: int) -> Track:
    sa, sb = _need(st, "stsd", sw)
    (count,) = _unpack(">4xI", data, sa, sb, f"{sw}/stsd")
    if count < 1:
        raise ValueError(f"{sw}/stsd: no sample entry")
    entries = list(_Boxes(data, sa + 8, sb, f"{sw}/stsd"))
    if not entries:
        raise ValueError(f"{sw}/stsd: no sample entry")
    kind, ea, eb = entries[0]
    if kind not in ("avc1", "avc3", "mp4v"):
        name = _CODECS.get(kind, "not H.264 or MPEG-4 Part 2")
        raise Unsupported(f"{sw}/stsd: a '{kind}' stream ({name}); only H.264 and MPEG-4 Part 2 "
                          "decode here")
    ew = f"{sw}/stsd/{kind}"
    width, height = _unpack(">24xHH", data, ea, eb, ew)
    inner = _children(data, ea + 78, eb, ew)
    sps: List[bytes] = []
    pps: List[bytes] = []
    length_size, config = 0, b""
    if kind == "mp4v":
        if "esds" not in inner:
            raise Unsupported(f"{ew}: an 'mp4v' stream without an 'esds' box (its "
                              "objectTypeIndication unknown)")
        config = _parse_esds(data, *inner["esds"], f"{ew}/esds")
    else:
        sps, pps, length_size = _parse_avcc(data, *_need(inner, "avcC", ew), f"{ew}/avcC")
    sizes_box = _need(st, "stsz", sw)
    (fixed, n) = _unpack(">4xII", data, *sizes_box, f"{sw}/stsz")
    if fixed:
        sizes = [fixed] * n
    else:
        sizes = _table("I", data, sizes_box[0] + 4, sizes_box[1], f"{sw}/stsz")
    if "stco" in st:
        chunks = _table("I", data, *st["stco"], f"{sw}/stco")
    else:
        chunks = _table("Q", data, *_need(st, "co64", sw), f"{sw}/co64")
    stsc = _table("III", data, *_need(st, "stsc", sw), f"{sw}/stsc")
    stts = _table("II", data, *_need(st, "stts", sw), f"{sw}/stts")
    offsets = _sample_offsets(stsc, chunks, sizes, f"{sw}/stsc")
    samples = []
    for i, (off, size) in enumerate(zip(offsets, sizes)):
        if off + size > file_size:
            raise ValueError(f"{sw}: sample {i} ({size} bytes at {off}) lies past the end of the "
                             f"file ({file_size} bytes)")
        samples.append(bytes(data[off:off + size]))
    ticks = sum(c * d for c, d in stts)
    frames = sum(c for c, _ in stts)
    if frames != len(samples):
        raise ValueError(f"{sw}/stts: {frames} sample durations for {len(samples)} samples")
    fps = timescale * frames / ticks if ticks and timescale else 0.0
    sync = None
    if "stss" in st:
        numbers = _table("I", data, *st["stss"], f"{sw}/stss")
        if any(not 1 <= k <= len(samples) for k in numbers) or numbers != sorted(set(numbers)):
            raise ValueError(f"{sw}/stss: sync samples {numbers[:8]} are not rising sample numbers "
                             f"of 1..{len(samples)}")
        sync = [k - 1 for k in numbers]
    return Track(sps, pps, length_size, samples, width, height,
                 int(round(fps)) if abs(fps - round(fps)) < 1e-9 else fps, kind, config, sync)


_CODECS = {"hvc1": "HEVC", "hev1": "HEVC", "av01": "AV1", "vp09": "VP9",
           "mjpa": "Motion JPEG", "jpeg": "Motion JPEG"}

# objectTypeIndication (ISO/IEC 14496-1 Table 5) of the visual streams an
# `mp4v` entry may carry; only 0x20 decodes here
MPEG4_VISUAL = 0x20
_OBJECT_TYPES = {0x21: "H.264", 0x60: "MPEG-2 video (Simple profile)",
                 0x61: "MPEG-2 video (Main profile)", 0x62: "MPEG-2 video (SNR profile)",
                 0x63: "MPEG-2 video (Spatial profile)", 0x64: "MPEG-2 video (High profile)",
                 0x65: "MPEG-2 video (4:2:2 profile)", 0x6A: "MPEG-1 video", 0x6C: "JPEG",
                 0x6D: "PNG", 0x6E: "JPEG 2000"}


def _descriptor(data, pos: int, end: int, tag: int, where: str) -> Tuple[int, int]:
    """The payload (start, end) of the descriptor with `tag` at `pos`: a
    tag byte, then a size in 1-4 bytes of 7 bits (ISO/IEC 14496-1 8.3.3)."""
    if pos >= end or data[pos] != tag:
        raise ValueError(f"{where}: descriptor tag {data[pos] if pos < end else None}, want {tag}")
    size, pos = 0, pos + 1
    for _ in range(4):
        if pos >= end:
            raise ValueError(f"{where}: descriptor {tag} cut in its size")
        byte = data[pos]
        pos += 1
        size = (size << 7) | (byte & 0x7F)
        if not byte & 0x80:
            break
    else:
        raise ValueError(f"{where}: descriptor {tag}'s size runs past 4 bytes")
    if pos + size > end:
        raise ValueError(f"{where}: descriptor {tag} of {size} bytes runs past its parent's "
                         f"{end - pos}")
    return pos, pos + size


def _parse_esds(data, a: int, b: int, where: str) -> bytes:
    """The DecoderSpecificInfo of the ES_Descriptor → DecoderConfigDescriptor
    in an `esds` full box (empty when there is none)."""
    if b - a < 4:
        raise ValueError(f"{where}: truncated")
    pos, end = _descriptor(data, a + 4, b, 3, where)  # ES_Descriptor
    if end - pos < 3:
        raise ValueError(f"{where}: an ES_Descriptor of {end - pos} bytes")
    flags = data[pos + 2]
    pos += 3
    if flags & 0x80:  # streamDependenceFlag: dependsOn_ES_ID
        pos += 2
    if flags & 0x40:  # URL_Flag: URLlength, URLstring
        if pos >= end:
            raise ValueError(f"{where}: an ES_Descriptor cut in its URL")
        pos += 1 + data[pos]
    if flags & 0x20:  # OCRstreamFlag: OCR_ES_Id
        pos += 2
    if pos > end:
        raise ValueError(f"{where}: an ES_Descriptor cut in its optional fields")
    pos, end = _descriptor(data, pos, end, 4, f"{where}/DecoderConfigDescriptor")
    if end - pos < 13:
        raise ValueError(f"{where}: a DecoderConfigDescriptor of {end - pos} bytes")
    kind = data[pos]
    if kind != MPEG4_VISUAL:
        raise Unsupported(f"{where}: objectTypeIndication 0x{kind:02X} "
                          f"({_OBJECT_TYPES.get(kind, 'not MPEG-4 Visual')}); only MPEG-4 "
                          "Visual (0x20) decodes in an 'mp4v' entry")
    pos += 13
    if pos == end or data[pos] != 5:
        return b""
    pos, stop = _descriptor(data, pos, end, 5, f"{where}/DecoderSpecificInfo")
    return bytes(data[pos:stop])


def _sample_offsets(stsc, chunks, sizes, where: str) -> List[int]:
    """The file offset of each sample from the sample-to-chunk runs."""
    offsets: List[int] = []
    n = len(sizes)
    for k, (first, per, _) in enumerate(stsc):
        last = stsc[k + 1][0] - 1 if k + 1 < len(stsc) else len(chunks)
        if first < 1 or last > len(chunks) or last < first - 1 or per > n:
            raise ValueError(f"{where}: run {k} (chunks {first}..{last} of {len(chunks)}, "
                             f"{per} samples each) is malformed")
        for c in range(first - 1, last):
            pos = chunks[c]
            for _ in range(per):
                if len(offsets) == n:
                    raise ValueError(f"{where}: chunks hold more samples than the {n} of stsz")
                offsets.append(pos)
                pos += sizes[len(offsets) - 1]
    if len(offsets) != n:
        raise ValueError(f"{where}: chunks hold {len(offsets)} samples, stsz {n}")
    return offsets
