"""Frame conversion, import and export (counterpart of hi3d_tpu/utils/video.py).

A clip is written as PNG frames (stdlib codec) and as an H.264 mp4 (an IDR
picture, then P pictures, deblocked) with the port's own encoder and muxer
(utils/h264.py, utils/mp4.py; no cv2 or imageio), on every host. It is
read back from such a frames directory or
mp4 with the same codecs, and an mp4 of cv2's `mp4v` (MPEG-4 Part 2, what
the JAX package writes where imageio has no ffmpeg plugin) with
utils/mpeg4.py; an mp4 the port's decoders do not take (the High-profile
streams of libx264, ...) goes to imageio or cv2 where they import, as JAX
reads it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import h264, mp4, mpeg4
from .image import load_image_rgb
from .png import write_png


def range_from_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 in [-1, 1] (x/255·2 − 1)."""
    return x.to(torch.float32) / 127.5 - 1.0


def denorm_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → uint8, tensor2vid's math: round((x·0.5+0.5)·255)."""
    return torch.round(x.clamp(-1.0, 1.0) * 127.5 + 127.5).to(torch.uint8)


def tensor2vid(
    video: np.ndarray,
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
) -> List[np.ndarray]:
    """(B, T, H, W, C) or (T, H, W, C) in [-1,1] (or uint8) → HWC uint8 frames."""
    video = np.asarray(video)
    if video.ndim == 5:
        video = video[0]
    if (video.dtype == np.uint8
            and tuple(mean) == (0.5, 0.5, 0.5)
            and tuple(std) == (0.5, 0.5, 0.5)):
        return list(video)
    video = video.astype(np.float32)
    video = video * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    video = np.clip(video, 0.0, 1.0)
    return [(f * 255.0).round().astype(np.uint8) for f in video]


def export_to_video(frames: List[np.ndarray], output_path: str, fps: int = 8,
                    quality: int = 9) -> str:
    """Write `frames/NNN.png` beside `output_path` and the H.264 mp4 at
    `output_path` (utils/h264.py, utils/mp4.py): an IDR picture, then P
    pictures with quarter-sample motion, the deblocking filter on, one QP
    for all from `quality` as imageio-ffmpeg's CRF (5 at the default 9),
    slices of 4 macroblock rows; `stss` names the IDR sample. Both hold the
    clip padded with its last frame to a whole number of seconds at `fps`
    (reference vtdm/util.py:44-47), so a reader of either sees the same
    frames. Returns the mp4 path, as JAX's export does; a failed encode
    raises."""
    out_dir = os.path.dirname(output_path) or "."
    frame_dir = os.path.join(out_dir, "frames")
    os.makedirs(frame_dir, exist_ok=True)
    padded = list(frames)
    if len(padded) % fps:
        padded += [padded[-1]] * (fps - len(padded) % fps)
    for i, f in enumerate(padded):
        write_png(os.path.join(frame_dir, f"{i:03d}.png"), f)
    h, w = padded[0].shape[:2]
    enc = h264.encode(padded, h264.quality_to_qp(quality), fps)
    size = mp4.write_mp4(output_path, enc.sps, enc.pps, enc.samples, w, h, fps, enc.sync)
    print(f"[video] wrote {len(frames)} frames, padded to {len(padded)}, to {frame_dir} and "
          f"{output_path} (H.264 IDR + P, deblocking on, QP {h264.quality_to_qp(quality)}, "
          f"{size} bytes)")
    return output_path


def read_mp4(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB of an mp4's video track, the first
    `max_frames` only when given: the port's own H.264 streams (the subset
    utils/h264.py decodes) and cv2's `mp4v` MPEG-4 Part 2 streams (the
    subset utils/mpeg4.py decodes), both turned to RGB by the BT.601
    limited-range inverse (`h264.to_rgb`, the matrix swscale assumes for
    streams that name none)."""
    track = mp4.read_mp4(path)
    samples = track.samples[:max_frames] if max_frames is not None else track.samples
    if track.codec == "mp4v":
        planes = mpeg4.decode(track.config, samples, os.path.basename(path))
    else:
        planes = h264.decode(track.sps, track.pps, samples, track.length_size,
                             os.path.basename(path))
    if not planes:
        raise ValueError(f"{os.path.basename(path)}: no frames")
    return np.stack([h264.to_rgb(*p) for p in planes])


def _read_foreign(path: str, max_frames: Optional[int]) -> List[np.ndarray]:
    """A stream the port's decoder refuses, read as JAX reads it: imageio's
    ffmpeg plugin, then cv2; raises ImportError when neither imports. (Only
    the ffmpeg plugin: without it imageio hands an mp4 to plugins that read
    no frames of it.)"""
    try:
        import imageio

        with imageio.get_reader(path, format="FFMPEG") as r:
            frames = []
            for f in r:
                if max_frames is not None and len(frames) >= max_frames:
                    break
                frames.append(np.asarray(f)[..., :3])
            return frames
    except (ImportError, ValueError):  # ValueError: imageio without an mp4 backend
        pass
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while max_frames is None or len(frames) < max_frames:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(np.ascontiguousarray(f[..., ::-1]))
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"cv2 read no frames from {path!r}")
    return frames


def import_video(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB frames, the first `max_frames` only when given:
    a directory of frame PNGs (read in name order with the stdlib codec, as
    `export_to_video` writes them) or an mp4 file, read with the port's
    H.264 or MPEG-4 Part 2 decoder. A stream outside their subsets
    (h264.Unsupported) is read through imageio or cv2 where one imports, as
    JAX reads it, and raises the refusal where neither does; a damaged file
    raises a ValueError."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path) if n.lower().endswith(".png"))
        if not names:
            raise FileNotFoundError(f"no .png frames in {path!r}")
        return np.stack([load_image_rgb(os.path.join(path, n)) for n in names[:max_frames]])
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        return read_mp4(path, max_frames)
    except h264.Unsupported as refusal:
        try:
            return np.stack(_read_foreign(path, max_frames))
        except ImportError:
            raise refusal from None
