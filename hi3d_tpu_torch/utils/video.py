"""Frame conversion, import and export (counterpart of hi3d_tpu/utils/video.py).

Frames are always written as PNGs with the stdlib codec; an mp4 is written
besides only when `imageio` or `cv2` can be imported on the host. A video
is read back from such a frames directory with the stdlib codec, or from an
mp4 when one of those readers imports.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

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


def _write_mp4(frames: List[np.ndarray], path: str, fps: int) -> str:
    """Returns the name of the writer used, or "" when none is usable."""
    try:
        import imageio

        with imageio.get_writer(path, fps=fps, quality=9, pixelformat="yuv420p") as w:
            for f in frames:
                w.append_data(f)
        return "imageio"
    except (ImportError, ValueError):  # ValueError: imageio without an mp4 backend
        pass
    try:
        import cv2
    except ImportError:
        return ""
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    return "cv2"


def export_to_video(frames: List[np.ndarray], output_path: str, fps: int = 8) -> str:
    """Write `frames/NNN.png` beside `output_path`, and the mp4 when a writer
    imports. Both hold the clip padded with its last frame to a whole number
    of seconds at `fps` (reference vtdm/util.py:44-47), so a reader of either
    sees the same frames. Returns the mp4 path, or the frames directory
    without one."""
    out_dir = os.path.dirname(output_path) or "."
    frame_dir = os.path.join(out_dir, "frames")
    os.makedirs(frame_dir, exist_ok=True)
    padded = list(frames)
    if len(padded) % fps:
        padded += [padded[-1]] * (fps - len(padded) % fps)
    for i, f in enumerate(padded):
        write_png(os.path.join(frame_dir, f"{i:03d}.png"), f)
    writers = ["png"]
    mp4 = _write_mp4(padded, output_path, fps)
    if mp4:
        writers.append(f"mp4:{mp4}")
    print(f"[video] wrote {len(frames)} frames, padded to {len(padded)}, to {frame_dir} "
          f"(writers: {', '.join(writers)})")
    return output_path if mp4 else frame_dir


def _read_mp4(path: str) -> List[np.ndarray]:
    try:
        import imageio

        with imageio.get_reader(path) as r:
            return [np.asarray(f)[..., :3] for f in r]
    except (ImportError, ValueError):  # ValueError: imageio without an mp4 backend
        pass
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"cannot read {path!r}: no mp4 reader (imageio or cv2) imports here; pass the "
            "stage-1 frames directory (<output_dir>/first_step/frames) instead") from None
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(np.ascontiguousarray(f[..., ::-1]))
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"cv2 read no frames from {path!r}")
    return frames


def import_video(path: str) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB frames: a directory of frame PNGs (read in
    name order with the stdlib codec, as `export_to_video` writes them) or
    an mp4 file (imageio or cv2; raises when neither imports)."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path) if n.lower().endswith(".png"))
        if not names:
            raise FileNotFoundError(f"no .png frames in {path!r}")
        return np.stack([load_image_rgb(os.path.join(path, n)) for n in names])
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return np.stack(_read_mp4(path))
