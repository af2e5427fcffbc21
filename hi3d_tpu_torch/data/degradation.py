"""Real-ESRGAN two-round degradation of the stage-2 conditioning video, on
the device in torch (counterpart of hi3d_tpu/data/degradation.py, which runs
the same plan on the host with cv2; the reference ran it on the GPU too).

`DegradedImages` takes the clean training video (B, T, 3, H, W) in [-1, 1],
already on the device where `VideoLDMStage2.add_custom_cond` runs, and gives
the degraded conditioning video: per-frame blur, a random resize, Gaussian or
Poisson noise, JPEG, a second round of the same, the final sinc filter and
JPEG in random order with the resize back, the background turned white, and
frame 0 kept clean. Each operation follows what the JAX package's cv2 call
computes:

- `filter2d`: per-frame 21×21 correlation (one grouped conv2d over frames ×
  channels) with cv2's BORDER_REFLECT (`fedcba|abcdef`, the edge repeated),
  built as an index map that follows cv2's borderInterpolate, so the padding
  stays right when it is wider than the frame;
- `resize`: cv2's float32 INTER_AREA, INTER_LINEAR and INTER_CUBIC as two
  separable weight matrices built on the host in float64 from cv2's own tap
  arithmetic (`resize_weights`), applied as two float64 products;
- Gaussian and Poisson noise (the gray variants broadcast one channel; λ
  from each frame's count of distinct `round(255·base)` levels, counted for
  all frames at once);
- `jpeg`: the lossy part of a baseline JPEG round trip as cv2's default
  encode and decode performs it with libjpeg(-turbo): truncation to uint8,
  the fixed-point RGB→YCbCr of jccolor.c, 4:2:0 chroma by h2v2_downsample
  (ordered 1,2 bias) with libjpeg's edge padding, the integer ISLOW forward
  DCT, quantisation by the Annex K tables at the IJG quality scaling, the
  integer ISLOW inverse DCT, h2v2 "fancy" (triangle) chroma upsampling and
  the fixed-point YCbCr→RGB of jdcolor.c. Entropy coding is lossless and is
  skipped. All of it is integer arithmetic (int32), so it can agree with
  cv2 exactly; tests/test_torch_stage2_training.py measures it. The decode
  side (dequantisation, IDCT, upsampling, colour conversion) is the JPEG
  decoder's, utils/jpeg.py.

The plan's scalars come from a numpy `RandomState`, drawn in exactly the
order of the JAX package's `degrade_clip` and `__call__`. Every large draw
(the Gaussian field, the Poisson sample) goes through `DegradedImages._noise`,
which draws on the device from a `torch.Generator`; the CPU tests replace it
with one that draws the same arrays from the plan's `RandomState` in NHWC
order, as the JAX package does, so both packages take the same path through
the plan. Without that replacement the stream is the port's own.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.jpeg import (blocks, descale, dequantize_idct, fix, transform_2d, upsample_h2v2,
                          ycc_to_rgb)
from .kernels import DEFAULT_DEGRADATION_OPT, sample_frame_kernels

RESIZE_MODES = ("area", "bilinear", "bicubic")


@contextlib.contextmanager
def _exact_fp32():
    """fp32 convolutions without TF32 (cuDNN's default allows it)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ------------------------------------------------------------------ filter2d

def reflect_index(n: int, pad: int) -> np.ndarray:
    """Source index of each position in [-pad, n + pad) under cv2's
    BORDER_REFLECT, as cv2's borderInterpolate computes it: reflected again
    while out of range, so a pad wider than the frame stays inside it."""
    out = np.empty(n + 2 * pad, np.int64)
    for i, p in enumerate(range(-pad, n + pad)):
        if n == 1:
            p = 0
        while not 0 <= p < n:
            p = -p - 1 if p < 0 else 2 * n - 1 - p
        out[i] = p
    return out


def filter2d(frames: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """cv2.filter2D(frame, -1, kernel, borderType=BORDER_REFLECT) for each
    frame: (T, C, H, W) float32 frames, (T, k, k) kernels (k odd, anchor at
    the centre) → (T, C, H, W)."""
    t, c, h, w = frames.shape
    k = kernels.shape[-1]
    pad = k // 2
    dev = frames.device
    rows = torch.from_numpy(reflect_index(h, pad)).to(dev)
    cols = torch.from_numpy(reflect_index(w, pad)).to(dev)
    x = frames.index_select(2, rows).index_select(3, cols)
    weight = kernels.to(dev, frames.dtype).repeat_interleave(c, dim=0)[:, None]
    with _exact_fp32():
        out = F.conv2d(x.reshape(1, t * c, h + 2 * pad, w + 2 * pad), weight, groups=t * c)
    return out.reshape(t, c, h, w)


# -------------------------------------------------------------------- resize

def _cubic_coeffs(x: np.float32) -> Tuple[np.float32, ...]:
    """cv2's interpolateCubic (A = -0.75), in float32 as cv2 computes it."""
    f = np.float32
    a = f(-0.75)
    x = f(x)
    c0 = ((a * (x + f(1)) - f(5) * a) * (x + f(1)) + f(8) * a) * (x + f(1)) - f(4) * a
    c1 = ((a + f(2)) * x - (a + f(3))) * x * x + f(1)
    c2 = ((a + f(2)) * (f(1) - x) - (a + f(3))) * (f(1) - x) * (f(1) - x) + f(1)
    return c0, c1, c2, f(1) - c0 - c1 - c2


def linear_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """cv2 float32 INTER_LINEAR along one axis: each output's two source
    indices and their float32 weights (half-pixel centres, clamped borders,
    tap positions computed in float32 as cv2 computes them)."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    sx = np.floor(f).astype(np.int64)
    fx = (f - sx.astype(np.float32)).astype(np.float32)
    fx[sx < 0], sx[sx < 0] = 0, 0
    edge = sx >= n_in - 1
    fx[edge], sx[edge] = 0, n_in - 1
    return sx, np.minimum(sx + 1, n_in - 1), np.float32(1) - fx, fx


def _lanczos4_coeffs(x: np.float32) -> np.ndarray:
    """cv2's interpolateLanczos4: 8 taps from double sines, normalised in
    float32 as cv2 normalises them."""
    if x < np.finfo(np.float32).eps:
        out = np.zeros(8, np.float32)
        out[3] = 1.0
        return out
    s45 = 0.70710678118654752440084436210485
    cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45))
    y0 = -(float(x) + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = np.empty(8, np.float32)
    total = np.float32(0)
    for i in range(8):
        y = -(float(x) + 3 - i) * math.pi * 0.25
        coeffs[i] = np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
        total = np.float32(total + coeffs[i])
    return (coeffs * (np.float32(1) / total)).astype(np.float32)


WEIGHT_MODES = RESIZE_MODES + ("nearest", "lanczos")


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int, mode: str, shrink: bool) -> np.ndarray:
    """(n_out, n_in) float64 weights of cv2.resize along one axis, for a
    float32 image; read-only. `shrink`: neither axis of the call grows (cv2
    takes INTER_AREA's exact box-overlap weights only then; where an axis
    grows, INTER_AREA uses its own linear-like taps on both axes).

    INTER_LINEAR: half-pixel centres, clamped borders, no antialias;
    INTER_CUBIC: A = -0.75, clamped borders; INTER_LANCZOS4 ("lanczos"): 8
    taps, clamped borders; the tap positions and weights are computed in
    float32, as cv2 computes them. INTER_NEAREST ("nearest"): source
    floor(dx · n_in / n_out), clamped."""
    if mode not in WEIGHT_MODES:
        raise ValueError(f"resize mode {mode!r} not in {WEIGHT_MODES}")
    m = np.zeros((n_out, n_in))
    if n_in == n_out:
        m[np.arange(n_in), np.arange(n_in)] = 1.0
    elif mode == "nearest":
        ifx = 1.0 / (n_out / n_in)
        src = np.minimum(np.floor(np.arange(n_out) * ifx).astype(np.int64), n_in - 1)
        m[np.arange(n_out), src] = 1.0
    elif mode == "bilinear":
        rows = np.arange(n_out)
        i0, i1, w0, w1 = linear_taps(n_in, n_out)
        np.add.at(m, (rows, i0), w0)
        np.add.at(m, (rows, i1), w1)
    elif mode == "area" and shrink:  # cv2 computeResizeAreaTab
        scale = 1.0 / (n_out / n_in)
        for dx in range(n_out):
            fsx1 = dx * scale
            fsx2 = fsx1 + scale
            cell = min(scale, n_in - fsx1)
            sx2 = min(math.floor(fsx2), n_in - 1)
            sx1 = min(math.ceil(fsx1), sx2)
            if sx1 - fsx1 > 1e-3:
                m[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
            for sx in range(sx1, sx2):
                m[dx, sx] += np.float32(1.0 / cell)
            if fsx2 - sx2 > 1e-3:
                m[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    elif mode == "lanczos":
        scale = 1.0 / (n_out / n_in)
        for dx in range(n_out):
            f = np.float32((dx + 0.5) * scale - 0.5)
            sx = int(np.floor(f))
            for j, c in enumerate(_lanczos4_coeffs(np.float32(f - np.float32(sx)))):
                m[dx, min(max(sx - 3 + j, 0), n_in - 1)] += c
    else:
        inv_scale = n_out / n_in
        scale = 1.0 / inv_scale
        for dx in range(n_out):
            if mode == "bicubic":
                f = np.float32((dx + 0.5) * scale - 0.5)
                sx = int(np.floor(f))
                for j, c in enumerate(_cubic_coeffs(np.float32(f - np.float32(sx)))):
                    m[dx, min(max(sx - 1 + j, 0), n_in - 1)] += c
                continue
            sx = math.floor(dx * scale)  # INTER_AREA growing: cv2's linear-like taps
            fx = np.float32((dx + 1) - (sx + 1) * inv_scale)
            fx = np.float32(0) if fx <= 0 else np.float32(fx - np.floor(fx))
            if sx < 0:
                fx, sx = np.float32(0), 0
            if sx >= n_in - 1:
                fx, sx = np.float32(0), n_in - 1
            m[dx, sx] += np.float32(1) - fx
            if fx:
                m[dx, sx + 1] += fx
    m.setflags(write=False)
    return m


def resize(frames: torch.Tensor, size: Tuple[int, int], mode: str) -> torch.Tensor:
    """cv2.resize(frame, (size[1], size[0]), interpolation=mode) for each
    (T, C, H, W) float32 frame: rows then columns by `resize_weights`, in
    float64, rounded to float32 once."""
    h, w = frames.shape[-2:]
    oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w):
        return frames
    shrink = oh <= h and ow <= w
    dev = frames.device
    wy = torch.tensor(resize_weights(h, oh, mode, shrink), device=dev)
    wx = torch.tensor(resize_weights(w, ow, mode, shrink), device=dev)
    return torch.matmul(torch.matmul(wy, frames.double()), wx.t()).float()


# --------------------------------------------------------------------- noise

def _gray(x: torch.Tensor) -> torch.Tensor:
    """Channel mean of (T, 3, H, W), summed in numpy's order for a float32
    mean over the last axis: (r + g) + b, then / 3."""
    return (x[:, 0:1] + x[:, 1:2] + x[:, 2:3]) / 3.0


def distinct_levels(base: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Per frame of (T, C, H, W), the count of distinct `round(255·base)`
    values (numpy's `len(np.unique(...))`), for all frames at once: one
    per-frame histogram over the range the values span. Returns the counts
    and that range's width, a bound on them known on the host (the call's
    one host sync)."""
    t = base.shape[0]
    levels = torch.round(base * 255.0).reshape(t, -1).to(torch.int64)
    lo, hi = (int(v) for v in torch.aminmax(levels))
    bins = hi - lo + 1
    idx = (levels - lo) + torch.arange(t, device=base.device)[:, None] * bins
    hist = torch.bincount(idx.reshape(-1), minlength=t * bins).reshape(t, bins)
    return (hist > 0).sum(dim=1), bins


def poisson_rate_scale(counts: torch.Tensor, most: int) -> torch.Tensor:
    """10 ** ceil(log10(max(count, 2))) per frame, in float64, by exact
    comparisons; `most` bounds the counts."""
    vals = torch.full(counts.shape, 10.0, dtype=torch.float64, device=counts.device)
    p = 10
    while p < most:
        vals = torch.where(counts > p, torch.full_like(vals, 10.0 * p), vals)
        p *= 10
    return vals


# ---------------------------------------------------------------------- JPEG

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_CHROMA_Q = np.full(64, 99, np.int64)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) 8×8 quantisation tables in natural order: Annex K
    scaled by the IJG quality formula (jpeg_quality_scaling), clamped to
    1..255 (force_baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).reshape(8, 8)
                 for t in (_LUMA_Q, _CHROMA_Q))


def _fdct_1d(d, final: bool):
    """One pass of libjpeg's jpeg_fdct_islow over 8 int32 tensors."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    sh = 15 if final else 11  # CONST_BITS ± PASS1_BITS
    o = [None] * 8
    if final:
        o[0], o[4] = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2)
    else:
        o[0], o[4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
    z1 = (tmp12 + tmp13) * 4433
    o[2] = descale(z1 + tmp13 * 6270, sh)
    o[6] = descale(z1 - tmp12 * 15137, sh)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    o[7] = descale(tmp4 + z1 + z3, sh)
    o[5] = descale(tmp5 + z2 + z4, sh)
    o[3] = descale(tmp6 + z2 + z3, sh)
    o[1] = descale(tmp7 + z1 + z4, sh)
    return o


def _code_plane(plane: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """Samples (T, 8·hb, 8·wb) int32 → the decoder's samples after the
    forward DCT, quantisation by `qt` (T, 8, 8), dequantisation and the
    inverse DCT."""
    x = blocks(plane) - 128
    coef = transform_2d(x, _fdct_1d, rows_first=True)  # scaled up by 8
    div = (qt * 8)[:, None, None]
    q = (coef.abs() + div // 2) // div
    return dequantize_idct(torch.where(coef < 0, -q, q), qt)


def _pad_edge(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Replicate the last row and column of (..., H, W) out to (h, w)."""
    rows = torch.arange(h, device=x.device).clamp(max=x.shape[-2] - 1)
    cols = torch.arange(w, device=x.device).clamp(max=x.shape[-1] - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def jpeg(frames: torch.Tensor, qualities: Sequence[int]) -> torch.Tensor:
    """A baseline JPEG encode and decode of each (T, 3, H, W) RGB frame in
    [0, 1] at its quality, as the JAX package's `_jpeg` gets it from cv2
    (libjpeg-turbo, 4:2:0, ISLOW DCT, fancy upsampling); the result is the
    decoded uint8 / 255 in float32. Frames must be at least 5 pixels wide
    (libjpeg upsamples narrower chroma without the triangle filter)."""
    t, _, h, w = frames.shape
    if w < 5:
        raise ValueError(f"jpeg: frames {w} pixels wide, at least 5 needed")
    dev = frames.device
    tables = [quant_tables(q) for q in qualities]
    luma_q = torch.from_numpy(np.stack([a for a, _ in tables]).astype(np.int32)).to(dev)
    chroma_q = torch.from_numpy(np.stack([b for _, b in tables]).astype(np.int32)).to(dev)

    u8 = (frames * 255.0).clamp(0, 255).to(torch.int32)  # astype(np.uint8) truncates
    r, g, b = u8[:, 0], u8[:, 1], u8[:, 2]
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16

    # luma: edges replicated out to whole blocks
    hb, wb = -(-h // 8), -(-w // 8)
    y = _code_plane(_pad_edge(y, 8 * hb, 8 * wb), luma_q)[:, :h, :w]

    # chroma: the image's rows replicated to an even count and its columns
    # to whole 16-pixel MCUs, h2v2_downsample with the 1,2,1,2 bias, then
    # the last chroma row replicated to whole blocks (jcprepct.c)
    ch_h, ch_w = -(-h // 16) * 8, -(-w // 16) * 8
    bias = torch.tensor([1, 2], dtype=torch.int32, device=dev).repeat(ch_w // 2)
    hc, wc = -(-h // 2), -(-w // 2)  # the decoder's downsampled size

    def chroma(p):
        p = _pad_edge(p, 2 * hc, 2 * ch_w)
        p = p.reshape(t, hc, 2, ch_w, 2).sum(dim=(2, 4), dtype=torch.int32)
        p = (p + bias) >> 2
        return _code_plane(_pad_edge(p, ch_h, ch_w), chroma_q)[:, :hc, :wc]

    cb, cr = (upsample_h2v2(chroma(p), h, w) for p in (cb, cr))
    rgb = ycc_to_rgb(y, cb, cr)
    return rgb.float() / 255.0


# ------------------------------------------------------------------ pipeline

class DegradedImages:
    """(B, T, 3, H, W) clean video in [-1, 1] → the degraded conditioning
    video, on the video's device. Takes the dataset's per-frame kernels
    (B, T, 21, 21), or samples them from the plan's RandomState when they
    are omitted, as the JAX package does."""

    @staticmethod
    def _noise(kind: str, arg, device: torch.device, rng: np.random.RandomState,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """Every large draw of the plan, in NHWC order. "normal": unit
        normals of shape `arg`, float32; "poisson": Poisson counts at the
        float64 rates `arg`, float64. Drawn on `device` from `generator`;
        `rng`, the plan's RandomState, is for a replacement that replays the
        JAX package's numpy draws."""
        if kind == "normal":
            return torch.randn(tuple(arg), generator=generator, device=device)
        return torch.poisson(arg, generator=generator)

    def _gaussian(self, x, rng, sigma_range, gray_prob, generator):
        sigma = rng.uniform(*sigma_range) / 255.0
        t, c, h, w = x.shape
        shape = (t, h, w, 1 if rng.uniform() < gray_prob else c)
        noise = self._noise("normal", shape, x.device, rng, generator).to(x.device)
        noise = noise.permute(0, 3, 1, 2) * float(np.float32(sigma))
        return (x + noise).clamp(0.0, 1.0)

    def _poisson(self, x, rng, scale_range, gray_prob, generator):
        scale = rng.uniform(*scale_range)
        base = _gray(x) if rng.uniform() < gray_prob else x
        vals = poisson_rate_scale(*distinct_levels(base))[:, None, None, None]
        rates = (base.clamp(0, 1).double() * vals).permute(0, 2, 3, 1)
        noisy = self._noise("poisson", rates, x.device, rng, generator).to(x.device)
        noise = (noisy.permute(0, 3, 1, 2) / vals - base.double()) * scale
        return (x.double() + noise).clamp(0.0, 1.0).float()

    def _noise_round(self, x, rng, prob, sigma_range, scale_range, gray_prob, generator):
        if rng.uniform() < prob:
            return self._gaussian(x, rng, sigma_range, gray_prob, generator)
        return self._poisson(x, rng, scale_range, gray_prob, generator)

    @staticmethod
    def _jpeg(x, rng, quality_range):
        return jpeg(x, [int(round(rng.uniform(*quality_range))) for _ in range(x.shape[0])])

    @staticmethod
    def _scale(rng, probs, lo_hi) -> float:
        updown = rng.choice(["up", "down", "keep"], p=probs)
        if updown == "up":
            return rng.uniform(1.0, lo_hi[1])
        if updown == "down":
            return rng.uniform(lo_hi[0], 1.0)
        return 1.0

    def degrade_clip(self, video: torch.Tensor, kernel1s: torch.Tensor, kernel2s: torch.Tensor,
                     sinc_kernels: torch.Tensor, rng: np.random.RandomState,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(T, 3, H, W) in [0, 1] → the degraded clip at (H, W), in [0, 1]."""
        opt = DEFAULT_DEGRADATION_OPT
        h, w = video.shape[-2:]
        scale_div = opt["scale"]

        # first degradation
        out = filter2d(video, kernel1s)
        s = self._scale(rng, opt["resize_prob"], opt["resize_range"])
        mode = RESIZE_MODES[rng.randint(3)]
        out = resize(out, (max(int(h * s), 8), max(int(w * s), 8)), mode)
        out = self._noise_round(out, rng, opt["gaussian_noise_prob"], opt["noise_range"],
                                opt["poisson_scale_range"], opt["gray_noise_prob"], generator)
        out = self._jpeg(out, rng, opt["jpeg_range"])

        # second degradation
        if rng.uniform() < opt["second_blur_prob"]:
            out = filter2d(out, kernel2s)
        s = self._scale(rng, opt["resize_prob2"], opt["resize_range2"])
        mode = RESIZE_MODES[rng.randint(3)]
        out = resize(out, (max(int(h / scale_div * s), 8), max(int(w / scale_div * s), 8)),
                     mode)
        out = self._noise_round(out, rng, opt["gaussian_noise_prob2"], opt["noise_range2"],
                                opt["poisson_scale_range2"], opt["gray_noise_prob2"], generator)

        # resize back + sinc and JPEG in random order
        lo_size = (h // scale_div, w // scale_div)
        if rng.uniform() < 0.5:
            out = resize(out, lo_size, RESIZE_MODES[rng.randint(3)])
            out = filter2d(out, sinc_kernels)
            out = self._jpeg(out, rng, opt["jpeg_range2"])
        else:
            out = self._jpeg(out, rng, opt["jpeg_range2"])
            out = resize(out, lo_size, RESIZE_MODES[rng.randint(3)])
            out = filter2d(out, sinc_kernels)

        out = torch.round(out * 255.0).clamp(0, 255) / 255.0
        return resize(out, (h, w), RESIZE_MODES[rng.randint(3)])

    @torch.no_grad()
    def __call__(self, video: torch.Tensor, masks: Optional[torch.Tensor] = None,
                 kernel1s=None, kernel2s=None, sinc_kernels=None, *,
                 rng: np.random.RandomState,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`video` (B, T, 3, H, W) in [-1, 1]; `masks` (B, T, H, W), 0 on the
        background, which turns white; `rng` the plan's RandomState;
        `generator` draws the noise fields. Frame 0 stays the clean frame."""
        video = video.float()
        dev = video.device
        b, t = video.shape[:2]
        out = torch.empty_like(video)
        for i in range(b):
            if kernel1s is None:
                ks = sample_frame_kernels(DEFAULT_DEGRADATION_OPT, t, rng)
            else:
                ks = (kernel1s[i], kernel2s[i], sinc_kernels[i])
            k1, k2, ks = (torch.as_tensor(k, dtype=torch.float32, device=dev) for k in ks)
            lq = self.degrade_clip(video[i] * 0.5 + 0.5, k1, k2, ks, rng, generator)
            if masks is not None:
                background = torch.as_tensor(masks[i], device=dev)[:, None] == 0
                lq = torch.where(background, torch.ones_like(lq), lq)
            out[i] = lq * 2.0 - 1.0
        out[:, 0] = video[:, 0]
        return out
