"""MPEG-4 Part 2 streams for tests/test_torch_mpeg4.py that cv2's
VideoWriter cannot be asked for (it writes no AC prediction, no dquant and
intra_dc_vlc_thr 0): a writer of random but valid Simple Profile syntax
(`random_stream`), headers with single tools switched on for the
refusals (`vol`, `vop_header`), and an ISO BMFF muxer of an `mp4v` track
(`write_mp4v`). cv2 (libavcodec) decodes what these write and is the
oracle; the VLC tables are read out of csrc/mpeg4_decode.c, so that a
table the decoder and this writer shared wrongly would show as a
disagreement with cv2.
"""

import os
import re
import struct

import numpy as np

from hi3d_tpu_torch.utils import mp4

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "hi3d_tpu_torch", "csrc", "mpeg4_decode.c")
INTRA_LAST, INTER_LAST = 67, 58


def _c_tables():
    text = open(CSRC).read()
    out = {}
    for m in re.finditer(r"static const \w+ (\w+)\[\d+\](?:\[2\])? = \{(.*?)\};", text, re.S):
        nums = [int(x, 0) for x in re.findall(r"0x[0-9a-f]+|\d+", m.group(2))]
        out[m.group(1)] = nums
    return out


T = _c_tables()


def _pairs(name):
    v = T[name]
    return [(v[i], v[i + 1]) for i in range(0, len(v), 2)]


class Bits:
    def __init__(self):
        self.bits = []

    def u(self, n, v):
        if n:
            self.bits.append(format(v & ((1 << n) - 1), f"0{n}b"))

    def code(self, cl):
        self.u(cl[1], cl[0])

    def stuff(self):
        """next_start_code(): a 0, then 1s to the byte boundary."""
        n = len("".join(self.bits))
        self.u(1, 0)
        self.u(-(n + 1) % 8, 0xFF)

    def bytes(self):
        s = "".join(self.bits)
        assert len(s) % 8 == 0
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


class Tcoef:
    """(last, run, level) -> TCOEF bits of one table, with the escapes."""

    def __init__(self, intra):
        vlc = _pairs("intra_vlc" if intra else "inter_vlc")
        run = T["intra_run" if intra else "inter_run"]
        level = T["intra_level" if intra else "inter_level"]
        last_from = INTRA_LAST if intra else INTER_LAST
        self.escape = vlc[102]
        self.codes, self.max_level, self.max_run = {}, {}, {}
        for s in range(102):
            last = int(s >= last_from)
            self.codes[(last, run[s], level[s])] = vlc[s]
            self.max_level[(last, run[s])] = max(self.max_level.get((last, run[s]), 0), level[s])
            self.max_run[(last, level[s])] = max(self.max_run.get((last, level[s]), 0), run[s])

    def write(self, w, last, run, level, rnd):
        a, sign = abs(level), int(level < 0)
        modes = []
        if (last, run, a) in self.codes:
            modes.append(("table", self.codes[(last, run, a)]))
        lmax = self.max_level.get((last, run), 0)
        if lmax and (last, run, a - lmax) in self.codes:
            modes.append(("esc1", self.codes[(last, run, a - lmax)]))
        rmax = self.max_run.get((last, a))
        if rmax is not None and (last, run - rmax - 1, a) in self.codes:
            modes.append(("esc2", self.codes[(last, run - rmax - 1, a)]))
        # the shortest form mostly, but every form now and then (a decoder
        # takes any of them)
        mode, code = modes[0] if modes and rnd.rand() < 0.8 else (
            modes[rnd.randint(len(modes))] if modes and rnd.rand() < 0.6 else ("esc3", None))
        if mode == "table":
            w.code(code)
        elif mode == "esc1":
            w.code(self.escape)
            w.u(1, 0)
            w.code(code)
        elif mode == "esc2":
            w.code(self.escape)
            w.u(2, 2)
            w.code(code)
        else:
            w.code(self.escape)
            w.u(2, 3)
            w.u(1, last)
            w.u(6, run)
            w.u(1, 1)
            w.u(12, level)
            w.u(1, 1)
            return
        w.u(1, sign)


INTRA, INTER = Tcoef(True), Tcoef(False)


def vos_vo():
    """VOS (Simple Profile level 1) and a video visual object, as lavc writes them."""
    return bytes.fromhex("000001b001" "000001b58913" "00000100")


def vol(width, height, resolution=8, verid=1, **tools):
    """A video_object_layer header (start code included) of a rectangular,
    progressive, 8-bit layer; `tools` switch single fields on: interlaced,
    obmc (obmc_disable 0), sprite (1 or 2), not_8_bit, quant_type,
    quarter_sample, complexity (estimation on), resync (markers on),
    data_partitioned, newpred, reduced_resolution, scalability, shape,
    chroma_format."""
    t = dict(tools)
    w = Bits()
    w.u(32, 0x120)
    w.u(1, 0)
    w.u(8, 1)
    w.u(1, 1)
    w.u(4, verid)
    w.u(3, 1)
    w.u(4, 1)
    w.u(1, 1)  # vol_control_parameters
    w.u(2, t.get("chroma_format", 1))
    w.u(1, 1)
    w.u(1, 0)
    w.u(2, t.get("shape", 0))
    w.u(1, 1)
    w.u(16, resolution)
    w.u(1, 1)
    w.u(1, 0)
    w.u(1, 1)
    w.u(13, width)
    w.u(1, 1)
    w.u(13, height)
    w.u(1, 1)
    w.u(1, t.get("interlaced", 0))
    w.u(1, 0 if t.get("obmc") else 1)
    w.u(1 if verid == 1 else 2, t.get("sprite", 0))
    w.u(1, t.get("not_8_bit", 0))
    w.u(1, t.get("quant_type", 0))
    if t.get("quant_type"):
        w.u(2, 0)  # the default matrices: load_intra_quant_mat 0, load_nonintra_quant_mat 0
    if verid != 1:
        w.u(1, t.get("quarter_sample", 0))
    w.u(1, 0 if t.get("complexity") else 1)
    w.u(1, 0 if t.get("resync") else 1)
    w.u(1, t.get("data_partitioned", 0))
    if t.get("data_partitioned"):
        w.u(1, t.get("reversible_vlc", 0))
    if verid != 1:
        w.u(1, t.get("newpred", 0))
        w.u(1, t.get("reduced_resolution", 0))
    w.u(1, t.get("scalability", 0))
    w.stuff()
    return w.bytes()


def vop_header(w, kind, time_bits, qscale, dc_thr=0, rounding=0, fcode=1, coded=1):
    w.u(32, 0x1B6)
    w.u(2, kind)
    w.u(1, 0)  # modulo_time_base
    w.u(1, 1)
    w.u(time_bits, 0)
    w.u(1, 1)
    w.u(1, coded)
    if not coded:
        return
    if kind == 1:
        w.u(1, rounding)
    w.u(3, dc_thr)
    w.u(5, qscale)
    if kind == 1:
        w.u(3, fcode)


DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)
Y_DC_SCALE, C_DC_SCALE = T["y_dc_scale"], T["c_dc_scale"]


class DcPredictor:
    """The reconstructed DC of every block of a VOP (1024 outside it and
    for inter macroblocks), to choose DC differences an encoder would write:
    the decoded level stays in 1 .. 2047 / dc_scale, as in a real stream."""

    def __init__(self, mb_w, mb_h):
        self.planes = [np.full((2 * mb_h + 1, 2 * mb_w + 1), 1024),
                       np.full((mb_h + 1, mb_w + 1), 1024), np.full((mb_h + 1, mb_w + 1), 1024)]

    def _cell(self, n, mb_x, mb_y):
        if n < 4:
            return self.planes[0], 2 * mb_y + (n >> 1) + 1, 2 * mb_x + (n & 1) + 1
        return self.planes[n - 3], mb_y + 1, mb_x + 1

    def diff(self, n, mb_x, mb_y, qscale, rnd=None):
        """A random DC difference for block n (0 without `rnd`); records
        the block's DC."""
        g, r, c = self._cell(n, mb_x, mb_y)
        a, b, top = g[r, c - 1], g[r - 1, c - 1], g[r - 1, c]
        scale = (Y_DC_SCALE if n < 4 else C_DC_SCALE)[qscale]
        pred = ((top if abs(a - b) < abs(b - top) else a) + (scale >> 1)) // scale
        level = pred if rnd is None else int(np.clip(pred + rnd.randint(-9, 10), 1, 2047 // scale))
        g[r, c] = min(level * scale, 2047)
        return int(level - pred)

    def clear(self, mb_x, mb_y):
        for n in range(6):
            g, r, c = self._cell(n, mb_x, mb_y)
            g[r, c] = 1024


def _dc(w, luma, diff):
    size = abs(diff).bit_length()
    w.code(_pairs("dc_lum_vlc" if luma else "dc_chrom_vlc")[size])
    if size:
        w.u(size, diff if diff > 0 else diff + (1 << size) - 1)
        if size > 8:
            w.u(1, 1)


def _coefs(w, table, prev, rnd, big, dc=None):
    """Random (run, level) pairs after scan position `prev` (0 after a DC
    VLC, -1 in an inter block or when the DC is the first coefficient:
    then `dc` is the DC difference, coded at position 0 when nonzero), the
    last one flagged; levels mostly small, now and then up to `big`, so
    that the dequantised coefficients stay those of a real stream."""
    pairs, lowest = [], prev + 1
    if dc is not None:
        lowest = 1
        if dc:
            pairs.append((0, dc))
            prev = 0
    while not pairs or (prev < 62 and rnd.rand() < 0.7):
        pos = int(min(max(prev + 1, lowest) + rnd.geometric(0.35) - 1, 63))
        level = int(rnd.randint(1, big + 1) if rnd.rand() < 0.08 else rnd.choice([1, 1, 1, 2, 2, 3]))
        pairs.append((pos - prev - 1, level if rnd.rand() < 0.5 else -level))
        prev = pos
    for k, (run, level) in enumerate(pairs):
        table.write(w, int(k == len(pairs) - 1), run, level, rnd)


def _big(qscale):
    return max(2, 400 // (2 * qscale + 1))


def _intra_mb(w, rnd, qscale, dc_thr, cbpc, dquant, dc, mb_x, mb_y):
    """ac_pred, cbpy, dquant and the six blocks of an intra macroblock;
    returns the qscale after it."""
    w.u(1, int(rnd.rand() < 0.5))  # ac_pred_flag
    cbpy = int(rnd.randint(16))
    w.code(_pairs("cbpy_vlc")[cbpy])
    dc_vlc = qscale < DC_THRESHOLD[dc_thr]
    if dquant:
        d = int(rnd.randint(4))
        w.u(2, d)
        qscale = min(31, max(1, qscale + (-1, -2, 1, 2)[d]))
    cbp = (cbpc & 3) | (cbpy << 2)
    for n in range(6):
        coded = (cbp >> (5 - n)) & 1
        diff = dc.diff(n, mb_x, mb_y, qscale, rnd if dc_vlc or coded else None)
        if dc_vlc:
            _dc(w, n < 4, diff)
            if coded:
                _coefs(w, INTRA, 0, rnd, _big(qscale))
        elif coded:
            _coefs(w, INTRA, -1, rnd, _big(qscale), diff)
    return qscale


def _vector(w, rnd, fcode, mv):
    for _ in range(2):
        code = int(rnd.randint(-32, 33) if rnd.rand() < 0.3 else rnd.randint(-3, 4))
        w.code(mv[abs(code)])
        if code:
            w.u(1, int(code < 0))
            w.u(fcode - 1, int(rnd.randint(1 << (fcode - 1))))


def random_stream(width, height, frames, seed, gop=4, fcodes=(1, 2, 3), p_intra=0.15,
                  p_skip=0.2, p_four=0.2, **vol_tools):
    """(decoder config, samples) of a random I/P stream: an I-VOP every
    `gop`, random qscale and intra_dc_vlc_thr a VOP; in P-VOPs not_coded,
    inter macroblocks of one vector (with and without dquant) or four,
    intra macroblocks, vectors of random codes under a random
    vop_fcode_forward and rounding type; stuffing codes now and then; a
    GOV header before each I-VOP. `vol_tools` go to `vol`."""
    rnd = np.random.RandomState(seed)
    mb_w, mb_h = -(-width // 16), -(-height // 16)
    intra_mcbpc, inter_mcbpc = (list(zip(T["intra_mcbpc_code"], T["intra_mcbpc_bits"])),
                                list(zip(T["inter_mcbpc_code"], T["inter_mcbpc_bits"])))
    mv = _pairs("mv_vlc")
    samples = []
    for i in range(frames):
        kind = 0 if i % gop == 0 else 1
        w = Bits()
        if kind == 0:  # GOV: time_code 0, closed_gov
            w.u(32, 0x1B3)
            w.u(11, 0)
            w.u(1, 1)
            w.u(6, 0)
            w.u(1, 1)
            w.u(1, 0)
            w.stuff()
        qscale = int(rnd.randint(1, 32))
        dc_thr = int(rnd.randint(8))
        fcode = int(rnd.choice(fcodes))
        vop_header(w, kind, 3, qscale, dc_thr, int(rnd.randint(2)), fcode)
        dc = DcPredictor(mb_w, mb_h)
        for mb in range(mb_w * mb_h):
            mb_x, mb_y = mb % mb_w, mb // mb_w
            if rnd.rand() < 0.03:  # stuffing (in a P-VOP after a not_coded 0)
                if kind:
                    w.u(1, 0)
                w.code(inter_mcbpc[20] if kind else intra_mcbpc[8])
            if kind == 0:
                dquant, cbpc = int(rnd.rand() < 0.3), int(rnd.randint(4))
                w.code(intra_mcbpc[4 * dquant + cbpc])
                qscale = _intra_mb(w, rnd, qscale, dc_thr, cbpc, dquant, dc, mb_x, mb_y)
                continue
            if rnd.rand() < p_skip:
                w.u(1, 1)  # not_coded
                dc.clear(mb_x, mb_y)
                continue
            w.u(1, 0)
            dquant, cbpc = int(rnd.rand() < 0.25), int(rnd.randint(4))
            if rnd.rand() < p_intra:
                w.code(inter_mcbpc[(12 if dquant else 4) + cbpc])
                qscale = _intra_mb(w, rnd, qscale, dc_thr, cbpc, dquant, dc, mb_x, mb_y)
                continue
            four = rnd.rand() < p_four
            if four:  # inter4v: no dquant
                dquant = 0
            w.code(inter_mcbpc[(16 if four else 8 if dquant else 0) + cbpc])
            dc.clear(mb_x, mb_y)
            coded = int(rnd.randint(16))
            w.code(_pairs("cbpy_vlc")[coded ^ 15])
            if dquant:
                d = int(rnd.randint(4))
                w.u(2, d)
                qscale = min(31, max(1, qscale + (-1, -2, 1, 2)[d]))
            for _ in range(4 if four else 1):
                _vector(w, rnd, fcode, mv)
            cbp = (cbpc & 3) | (coded << 2)
            for n in range(6):
                if (cbp >> (5 - n)) & 1:
                    _coefs(w, INTER, -1, rnd, _big(qscale))
        w.stuff()
        samples.append(w.bytes())
    return vos_vo() + vol(width, height, **vol_tools), samples


def write_mp4v(path, config, samples, width, height, fps=8, object_type=0x20):
    """An mp4 of one `mp4v` track: its esds holds `config` as the
    DecoderSpecificInfo under objectTypeIndication `object_type`."""
    def desc(tag, body):
        n = len(body)
        return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F,
                      n & 0x7F]) + body

    dcd = desc(4, bytes([object_type, 0x11]) + bytes(3) + struct.pack(">II", 0, 0)
               + desc(5, config))
    esds = mp4.full_box(b"esds", 0, 0, desc(3, struct.pack(">HB", 1, 0) + dcd + desc(6, b"\x02")))
    entry = mp4.box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                    struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1),
                    bytes(32), struct.pack(">Hh", 0x18, -1), esds)
    n = len(samples)
    ftyp = mp4.box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2mp41")
    offsets, pos = [], len(ftyp) + 8
    for s in samples:
        offsets.append(pos)
        pos += len(s)
    stbl = mp4.box(b"stbl", mp4.full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
                   mp4.full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1)),
                   mp4.full_box(b"stss", 0, 0, struct.pack(">II", 1, 1)),
                   mp4.full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
                   mp4.full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *map(len, samples))),
                   mp4.full_box(b"stco", 0, 0, struct.pack(f">I{n}I", n, *offsets)))
    minf = mp4.box(b"minf", mp4.full_box(b"vmhd", 0, 1, bytes(8)),
                   mp4.box(b"dinf", mp4.full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                                 mp4.full_box(b"url ", 0, 1))), stbl)
    mdia = mp4.box(b"mdia", mp4.full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, fps, n),
                                         struct.pack(">HH", 0x55C4, 0)),
                   mp4.full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0"),
                   minf)
    tkhd = mp4.full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, n * 1000 // fps), bytes(8),
                        struct.pack(">hhhH", 0, 0, 0, 0), mp4.MATRIX,
                        struct.pack(">II", width << 16, height << 16))
    mvhd = mp4.full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, n * 1000 // fps),
                        struct.pack(">IH", 0x10000, 0x100), bytes(10), mp4.MATRIX, bytes(24),
                        struct.pack(">I", 2))
    moov = mp4.box(b"moov", mvhd, mp4.box(b"trak", tkhd, mdia))
    with open(path, "wb") as f:
        f.write(ftyp + struct.pack(">I", 8 + sum(map(len, samples))) + b"mdat" + b"".join(samples)
                + moov)
    return path
