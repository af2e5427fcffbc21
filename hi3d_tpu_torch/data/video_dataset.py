"""Orbit-render datasets and prefetching loader (counterpart of the folder
datasets of hi3d_tpu/data/video_dataset.py).

A render folder holds 96 PNG frames: 6 elevation bands
(-10, 0, 10, 20, 30, 40) × 16 azimuths. A sample picks a random folder and a
random start frame; the start frame's band gives the elevation and a cyclic
16-frame window inside that band. RGBA is composited on white exactly as the
JAX package's `_rgba_white` does (float, then truncation to uint8), frames
are resized to the configured size when they differ (cv2 INTER_LINEAR
sampling, utils/image.py) and scaled to [-1, 1]. Decoding uses the port's
stdlib PNG reader: no cv2, no native loader.

Stage 2 (`VideoTrainDatasetStage2`, `VideoDatasetStage2`) adds each frame's
foreground mask — alpha / 255 resized with cv2's float INTER_LINEAR, then
> 0.5, as the JAX loader's cv2 path — and per-frame Real-ESRGAN blur kernels
drawn on the host (data/kernels.py); the degradation itself runs on the
device (data/degradation.py).

Layout: the port's NCHW — a sample's video is (T, 3, H, W) float32, a batch's
(B, T, 3, H, W); masks are (T, H, W). Tar-shard datasets are not ported.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.image import resize_bilinear_u8
from ..utils.png import read_png
from .degradation import linear_taps
from .kernels import DEFAULT_DEGRADATION_OPT, sample_frame_kernels

ELEVATION_BANDS = (-10, 0, 10, 20, 30, 40)
BAND = 16


def rgba_white(img: np.ndarray) -> np.ndarray:
    """Decoded uint8 image (H, W, C) → RGB uint8 on white, as the JAX
    package's `_rgba_white`: alpha blend in float32, truncated to uint8."""
    if img.shape[-1] in (1, 2):  # gray (+ alpha) → RGB (+ alpha)
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    if img.shape[-1] == 4:
        rgba = img.astype(np.float32) / 255.0
        mask = rgba[..., 3:]
        rgb = rgba[..., :3] * mask + 1.0 - mask
        return (rgb * 255.0).astype(np.uint8)
    return img


def alpha_mask(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """(H, W) float32 foreground mask of a decoded uint8 image, as the JAX
    loader's cv2 path makes it: alpha / 255 in float32, resized to `size_wh`
    (cv2 argument order) with cv2's float INTER_LINEAR (two taps per output
    pixel on each axis, rows then columns), then > 0.5; all ones for an image
    without alpha."""
    w, h = size_wh
    if img.shape[-1] not in (2, 4):
        return np.ones((h, w), np.float32)
    a = img[..., -1].astype(np.float32) / 255.0
    if a.shape != (h, w):
        y0, y1, wy0, wy1 = linear_taps(a.shape[0], h)
        x0, x1, wx0, wx1 = linear_taps(a.shape[1], w)
        a = a.astype(np.float64)
        rows = a[y0] * wy0[:, None] + a[y1] * wy1[:, None]
        a = (rows[:, x0] * wx0 + rows[:, x1] * wx1).astype(np.float32)
    return (a > 0.5).astype(np.float32)


def select_window(frames: List, rng: np.random.RandomState, sample_frames: int) -> Tuple[List, int]:
    """Cyclic window inside the elevation band of a random start frame."""
    start = int(rng.randint(len(frames)))
    band_id = start // BAND
    elevation = ELEVATION_BANDS[min(band_id, len(ELEVATION_BANDS) - 1)]
    lo, hi = band_id * BAND, (band_id + 1) * BAND
    selected = [frames[i] for i in range(start, hi)] + [frames[i] for i in range(lo, start)]
    return selected[:sample_frames], elevation


class VideoTrainDataset:
    """Stage-1 training samples from folder-of-frames orbit renders."""

    def __init__(self, base_folder: str, width: int = 512, height: int = 512,
                 sample_frames: int = 16):
        self.base_folder = base_folder
        self.folders = sorted(os.listdir(base_folder))
        if not self.folders:
            raise ValueError(f"no render folders under {base_folder}")
        self.width = int(width)
        self.height = int(height)
        self.sample_frames = int(sample_frames)

    def __len__(self) -> int:
        return len(self.folders)

    def _frame(self, img: np.ndarray) -> np.ndarray:
        """A decoded PNG as (3, H, W) in [-1, 1] on white."""
        rgb = resize_bilinear_u8(rgba_white(img), (self.width, self.height))
        return (rgb.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)

    def _load_frame(self, path: str) -> np.ndarray:
        return self._frame(read_png(path))

    def _window(self, folder: str, rng: np.random.RandomState) -> Tuple[List[str], int]:
        """The paths of a random window of `folder`'s frames, and its elevation."""
        folder_path = os.path.join(self.base_folder, folder)
        frames = sorted(os.listdir(folder_path))
        if len(frames) < self.sample_frames:
            raise ValueError(f"folder {folder!r} has {len(frames)} < {self.sample_frames} frames")
        selected, elevation = select_window(frames, rng, self.sample_frames)
        return [os.path.join(folder_path, n) for n in selected], elevation

    def sample(self, rng: np.random.RandomState) -> Dict:
        folder = self.folders[int(rng.randint(len(self.folders)))]
        paths, elevation = self._window(folder, rng)
        video = np.stack([self._load_frame(p) for p in paths])
        selected = [os.path.basename(p) for p in paths]
        return {
            "video": video,  # (T, 3, H, W) in [-1, 1]
            "elevation": np.float32(elevation),
            "caption": f"{folder}_{selected[0]}",
            "fps_id": np.int32(7),
            "motion_bucket_id": np.int32(127),
        }

    def __getitem__(self, idx: int) -> Dict:
        return self.sample(np.random.RandomState(idx))


class VideoTrainDatasetStage2(VideoTrainDataset):
    """Stage-2 training samples: the stage-1 window plus each frame's mask
    and its degradation kernels (`sample_frame_kernels`, drawn from the same
    RandomState after the window, as the JAX package draws them).
    `depth_folder` is accepted for the reference config's sake and unused:
    the DepthEmbedder computes depth at train time."""

    def __init__(self, *args, degradation_opt: Optional[dict] = None,
                 depth_folder: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.opt = dict(DEFAULT_DEGRADATION_OPT, **(degradation_opt or {}))

    def sample(self, rng: np.random.RandomState) -> Dict:
        folder = self.folders[int(rng.randint(len(self.folders)))]
        paths, elevation = self._window(folder, rng)
        imgs = [read_png(p) for p in paths]
        frames = [self._frame(img) for img in imgs]
        masks = [alpha_mask(img, (self.width, self.height)) for img in imgs]
        k1, k2, ks = sample_frame_kernels(self.opt, self.sample_frames, rng)
        return {
            "video": np.stack(frames),  # (T, 3, H, W) in [-1, 1]
            "masks": np.stack(masks),  # (T, H, W), 0 on the background
            "elevation": np.float32(elevation),
            "caption": folder,
            "kernel1s": k1,  # (T, 21, 21) each
            "kernel2s": k2,
            "sinc_kernels": ks,
        }


def _collate(samples: List[Dict]) -> Dict:
    out: Dict = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return out


class PrefetchLoader:
    """Worker threads fill a bounded queue with samples; iterating yields
    collated numpy batches forever. Stopping the iteration stops the
    workers."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.seed = seed
        self.num_workers = max(1, int(num_workers))
        self.prefetch = prefetch

    def __iter__(self) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        stop = threading.Event()

        def worker(wid: int):
            rng = np.random.RandomState(self.seed * 100003 + wid)
            while not stop.is_set():
                sample = self.dataset.sample(rng)
                while not stop.is_set():
                    try:
                        q.put(sample, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                yield _collate([q.get() for _ in range(self.batch_size)])
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)


class VideoDataset:
    """Config-facing data module (the `data:` section of train-v01.yaml)."""

    def __init__(self, base_folder: str, eval_folder: Optional[str] = None, width: int = 512,
                 height: int = 512, sample_frames: int = 16, batch_size: int = 1,
                 num_workers: int = 4, seed: int = 0):
        if ".tar" in str(base_folder):
            raise NotImplementedError("tar-shard datasets are not ported yet (later PR)")
        self.base_folder = base_folder
        self.eval_folder = eval_folder
        self.width, self.height = int(width), int(height)
        self.sample_frames = int(sample_frames)
        self.batch_size = int(batch_size)
        self.num_workers = int(num_workers)
        self.seed = int(seed)
        self.train_dataset: Optional[VideoTrainDataset] = None

    def setup(self) -> "VideoDataset":
        self.train_dataset = VideoTrainDataset(self.base_folder, self.width, self.height,
                                               self.sample_frames)
        return self

    def train_dataloader(self) -> Iterator[Dict]:
        if self.train_dataset is None:
            self.setup()
        return iter(PrefetchLoader(self.train_dataset, self.batch_size, seed=self.seed,
                                   num_workers=self.num_workers))


class VideoDatasetStage2(VideoDataset):
    """The `data:` section of train-v02.yaml: VideoDataset over
    `VideoTrainDatasetStage2`; `degradation_opt` overrides the kernels'
    Real-ESRGAN settings, `depth_folder` is accepted and unused."""

    def __init__(self, *args, degradation_opt: Optional[dict] = None,
                 depth_folder: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.degradation_opt = degradation_opt

    def setup(self) -> "VideoDatasetStage2":
        self.train_dataset = VideoTrainDatasetStage2(
            self.base_folder, self.width, self.height, self.sample_frames,
            degradation_opt=self.degradation_opt)
        return self
