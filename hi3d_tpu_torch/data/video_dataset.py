"""Stage-1 orbit-render dataset and prefetching loader (counterpart of the
stage-1 parts of hi3d_tpu/data/video_dataset.py).

A render folder holds 96 PNG frames: 6 elevation bands
(-10, 0, 10, 20, 30, 40) × 16 azimuths. A sample picks a random folder and a
random start frame; the start frame's band gives the elevation and a cyclic
16-frame window inside that band. RGBA is composited on white exactly as the
JAX package's `_rgba_white` does (float, then truncation to uint8), frames
are resized to the configured size when they differ (cv2 INTER_LINEAR
sampling, utils/image.py) and scaled to [-1, 1]. Decoding uses the port's
stdlib PNG reader: no cv2, no native loader.

Layout: the port's NCHW — a sample's video is (T, 3, H, W) float32, a batch's
(B, T, 3, H, W). The stage-2 dataset, tar shards and degradation come with
the stage-2 slice.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.image import resize_bilinear_u8
from ..utils.png import read_png

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

    def _load_frame(self, path: str) -> np.ndarray:
        rgb = rgba_white(read_png(path))
        rgb = resize_bilinear_u8(rgb, (self.width, self.height))
        return (rgb.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)

    def sample(self, rng: np.random.RandomState) -> Dict:
        folder = self.folders[int(rng.randint(len(self.folders)))]
        folder_path = os.path.join(self.base_folder, folder)
        frames = sorted(os.listdir(folder_path))
        if len(frames) < self.sample_frames:
            raise ValueError(f"folder {folder!r} has {len(frames)} < {self.sample_frames} frames")
        selected, elevation = select_window(frames, rng, self.sample_frames)
        video = np.stack([self._load_frame(os.path.join(folder_path, n)) for n in selected])
        return {
            "video": video,  # (T, 3, H, W) in [-1, 1]
            "elevation": np.float32(elevation),
            "caption": f"{folder}_{selected[0]}",
            "fps_id": np.int32(7),
            "motion_bucket_id": np.int32(127),
        }

    def __getitem__(self, idx: int) -> Dict:
        return self.sample(np.random.RandomState(idx))


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
