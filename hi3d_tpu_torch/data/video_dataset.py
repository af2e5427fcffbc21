"""Orbit-render datasets and prefetching loader (counterpart of the folder
datasets of hi3d_tpu/data/video_dataset.py).

A render folder holds 96 PNG frames: 6 elevation bands
(-10, 0, 10, 20, 30, 40) × 16 azimuths. A sample picks a random folder and a
random start frame; the start frame's band gives the elevation and a cyclic
16-frame window inside that band. RGBA is composited on white exactly as the
JAX package's `_rgba_white` does (float, then truncation to uint8), frames
are resized to the configured size when they differ (cv2 INTER_LINEAR
sampling, utils/image.py) and scaled to [-1, 1]. Frames decode with the
port's PNG reader or JPEG decoder (`utils.image.read_image`, by the file's
signature, as cv2 tells them apart): no cv2, no native loader.

Stage 2 (`VideoTrainDatasetStage2`, `VideoDatasetStage2`) adds each frame's
foreground mask — alpha / 255 resized with cv2's float INTER_LINEAR, then
> 0.5, as the JAX loader's cv2 path — and per-frame Real-ESRGAN blur kernels
drawn on the host (data/kernels.py); the degradation itself runs on the
device (data/degradation.py).

Tar shards (`TarShardVideoDataset`, its stage-2 subclass,
`pack_folder_to_shards`): `.tar` files whose members are
`<object>/<frame>` images (PNG or JPEG), each object's frames contiguous, read in stream
mode; each process takes `order[process_index::process_count]` of the
shards (all of them when that is empty), reshuffled every epoch with
`seed + epoch`; by default the process's rank and the world size of its
process group (0 and 1 outside one). PNG and JPEG members decode with the
port's readers (`utils.image.decode_image`), as the JAX package's with
cv2.

The eval set (`SyncDreamerEvalData`, `prepare_eval_input`) crops RGBA
images to their alpha, resizes them with PIL's antialiased BICUBIC
(utils/image.resize_bicubic_u8, bit-equal to PIL) and composites them on
white, without PIL.

Layout: the port's NCHW — a sample's video is (T, 3, H, W) float32, a batch's
(B, T, 3, H, W); masks are (T, H, W). The eval set's `input_image` keeps the
JAX package's (H, W, 3).
"""

from __future__ import annotations

import glob
import os
import queue
import tarfile
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..parallel import dist as pdist
from ..utils.image import decode_image, read_image, resize_bicubic_u8, resize_bilinear_u8
from ..utils.png import decode_png, png_colour_type
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
    pixel on each axis, columns then rows, in float32 as cv2 sums them),
    then > 0.5; all ones for an image without alpha."""
    w, h = size_wh
    if img.shape[-1] not in (2, 4):
        return np.ones((h, w), np.float32)
    a = img[..., -1].astype(np.float32) / 255.0
    if a.shape != (h, w):
        y0, y1, wy0, wy1 = linear_taps(a.shape[0], h)
        x0, x1, wx0, wx1 = linear_taps(a.shape[1], w)
        cols = a[:, x0] * wx0 + a[:, x1] * wx1
        a = cols[y0] * wy0[:, None] + cols[y1] * wy1[:, None]
    return (a > 0.5).astype(np.float32)


def _frame(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """A decoded image as (3, height, width) in [-1, 1] on white."""
    rgb = resize_bilinear_u8(rgba_white(img), (width, height))
    return (rgb.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)


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
        return _frame(img, self.width, self.height)

    def _load_frame(self, path: str) -> np.ndarray:
        return self._frame(read_image(path))

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
        imgs = [read_image(p) for p in paths]
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


class TarShardVideoDataset:
    """Training samples streamed from tar shards of orbit renders (the JAX
    package's `TarShardVideoDataset`): the same window, compositing, resize
    and keys as `VideoTrainDataset`, with the caption `<object>_<frame>`.
    Objects come in shard order, one after another, across threads (`sample`
    takes a lock); `process_index`/`process_count` pick this process's share
    of the shards: by default its rank and the group's size (`parallel.dist`),
    0 and 1 (all of them) on one GPU; values given win."""

    stage2 = False

    def __init__(self, shards, width: int = 512, height: int = 512, sample_frames: int = 16,
                 seed: int = 0, shuffle_shards: bool = True,
                 process_index: Optional[int] = None, process_count: Optional[int] = None,
                 degradation_opt: Optional[dict] = None):
        self.shards = sorted(glob.glob(shards)) if isinstance(shards, str) else sorted(shards)
        if not self.shards:
            raise ValueError(f"no tar shards match {shards!r}")
        self.width, self.height = int(width), int(height)
        self.sample_frames = int(sample_frames)
        self.seed = seed
        self.shuffle_shards = shuffle_shards
        self.process_index = int(pdist.rank() if process_index is None else process_index)
        self.process_count = int(pdist.world() if process_count is None else process_count)
        self._lock = threading.Lock()
        self._it = self._objects()
        if self.stage2:
            self.opt = dict(DEFAULT_DEGRADATION_OPT, **(degradation_opt or {}))

    def _host_shards(self, epoch: int) -> List[str]:
        """This process's shards in `epoch`: the shard list, permuted by a
        RandomState seeded `seed + epoch` when shuffling, then every
        `process_count`-th from `process_index`; all of them when that
        leaves none."""
        order = list(self.shards)
        if self.shuffle_shards:
            perm = np.random.RandomState(self.seed + epoch).permutation(len(order))
            order = [order[i] for i in perm]
        return order[self.process_index::self.process_count] or order

    def _objects(self) -> Iterator[Tuple[str, Dict[str, bytes]]]:
        """(object name, {frame name: encoded bytes}) forever, epoch after
        epoch, each shard read in stream mode."""
        epoch = 0
        while True:
            for shard in self._host_shards(epoch):
                with tarfile.open(shard, mode="r|*") as tf:
                    cur: Optional[str] = None
                    files: Dict[str, bytes] = {}
                    for member in tf:
                        if not member.isfile():
                            continue
                        obj, _, fname = member.name.partition("/")
                        if obj != cur and files:
                            yield cur, files
                            files = {}
                        cur = obj
                        files[fname] = tf.extractfile(member).read()
                    if files:
                        yield cur, files
            epoch += 1

    def sample(self, rng: np.random.RandomState) -> Dict:
        with self._lock:
            name, files = next(self._it)
        frames = sorted(files)
        if len(frames) < self.sample_frames:
            raise ValueError(f"object {name!r} has {len(frames)} < {self.sample_frames} frames")
        selected, elevation = select_window(frames, rng, self.sample_frames)
        imgs = [decode_image(files[f], f"{name}/{f}") for f in selected]
        out: Dict = {
            "video": np.stack([_frame(img, self.width, self.height) for img in imgs]),
            "elevation": np.float32(elevation),
            "caption": f"{name}_{selected[0]}",
            "fps_id": np.int32(7),
            "motion_bucket_id": np.int32(127),
        }
        if self.stage2:
            k1, k2, ks = sample_frame_kernels(self.opt, self.sample_frames, rng)
            del out["fps_id"], out["motion_bucket_id"]
            out.update(caption=name, kernel1s=k1, kernel2s=k2, sinc_kernels=ks,
                       masks=np.stack([alpha_mask(img, (self.width, self.height))
                                       for img in imgs]))
        return out


class TarShardVideoDatasetStage2(TarShardVideoDataset):
    """Stage-2 samples from tar shards: masks and the frame kernels, the
    caption the object's name, no fps_id or motion_bucket_id."""

    stage2 = True


def pack_folder_to_shards(base_folder: str, out_dir: str, objects_per_shard: int = 64,
                          prefix: str = "renders") -> List[str]:
    """Pack folders of frames into tar shards of `objects_per_shard` whole
    objects, members `<object>/<frame>` in sorted order; returns the shard
    paths (`<prefix>-NNNNN.tar`)."""
    os.makedirs(out_dir, exist_ok=True)
    folders = sorted(os.listdir(base_folder))
    paths: List[str] = []
    for s0 in range(0, len(folders), objects_per_shard):
        shard = os.path.join(out_dir, f"{prefix}-{s0 // objects_per_shard:05d}.tar")
        with tarfile.open(shard, "w") as tf:
            for obj in folders[s0:s0 + objects_per_shard]:
                d = os.path.join(base_folder, obj)
                for frame in sorted(os.listdir(d)):
                    tf.add(os.path.join(d, frame), arcname=f"{obj}/{frame}")
        paths.append(shard)
    return paths


def _paste(canvas: np.ndarray, img: np.ndarray, x: int, y: int) -> None:
    """PIL's `paste` without a mask: copy, clipped to the canvas."""
    h, w = img.shape[:2]
    ch, cw = canvas.shape[:2]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + h, ch), min(x + w, cw)
    if y1 > y0 and x1 > x0:
        canvas[y0:y1, x0:x1] = img[y0 - y:y1 - y, x0 - x:x1 - x]


def prepare_eval_input(image_path: str, elevation: float = 0.0, crop_size: int = -1,
                       image_size: int = 512) -> Dict:
    """An eval image as the JAX package's `prepare_eval_input` makes it,
    without PIL: an RGBA image with `crop_size` set is cropped to the box
    (min x, min y, max x, max y) of its nonzero alpha — the last row and
    column of the box left out, as PIL's crop does — resized so its longer
    side is `crop_size` (sizes truncated), and centred on a transparent
    black `image_size`² canvas; otherwise the image is centred on a black
    (transparent) square of its longer side and resized to `image_size`².
    Resizes are `resize_bicubic_u8`. RGBA is then composited on white.
    Returns {"input_image": (image_size, image_size, 3) float32 in [-1, 1],
    "input_elevation": elevation in radians}. 8-bit RGB and RGBA PNGs only."""
    with open(image_path, "rb") as f:
        blob = f.read()
    colour = png_colour_type(blob, image_path)
    if colour not in (2, 6):
        raise ValueError(f"{image_path}: PNG colour type {colour}; the eval set reads 8-bit RGB "
                         "(2) and RGBA (6) images")
    image = decode_png(blob, image_path)
    if crop_size != -1 and image.shape[-1] == 4:
        ys, xs = np.nonzero(image[:, :, 3])
        ref = image[ys.min():ys.max(), xs.min():xs.max()]
        scale = crop_size / max(ref.shape[0], ref.shape[1])
        ref = resize_bicubic_u8(ref, (int(scale * ref.shape[1]), int(scale * ref.shape[0])))
        image = np.zeros((image_size, image_size, 4), np.uint8)
        _paste(image, ref, (image_size - ref.shape[1]) // 2, (image_size - ref.shape[0]) // 2)
    else:
        side = max(image.shape[0], image.shape[1])
        canvas = np.zeros((side, side, image.shape[-1]), np.uint8)
        _paste(canvas, image, (side - image.shape[1]) // 2, (side - image.shape[0]) // 2)
        image = resize_bicubic_u8(canvas, (image_size, image_size))
    arr = image.astype(np.float32) / 255.0
    if arr.shape[-1] == 4:
        mask = arr[:, :, 3:]
        arr = arr[:, :, :3] * mask + 1.0 - mask
    return {"input_image": arr * 2.0 - 1.0, "input_elevation": np.float32(np.deg2rad(elevation))}


class SyncDreamerEvalData:
    """The eval set: every `.png` of `image_dir` in name order, each
    `prepare_eval_input` at `image_size` with `crop_size` (the JAX package
    passes `image_size` for both). Raises when `image_dir` does not exist."""

    def __init__(self, image_dir: str, image_size: int = 512, crop_size: int = 20):
        self.image_size = image_size
        self.crop_size = crop_size
        self.fns = sorted(fn for fn in Path(image_dir).iterdir() if fn.suffix == ".png")

    def __len__(self) -> int:
        return len(self.fns)

    def __getitem__(self, index: int) -> Dict:
        return prepare_eval_input(str(self.fns[index]), 0.0, self.image_size, self.image_size)


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
    """Config-facing data module (the `data:` section of train-v01.yaml). A
    `base_folder` containing ".tar" (a glob or a shard) streams tar shards,
    taking `degradation_opt`, `shuffle_shards`, `process_index` and
    `process_count` from the extra keyword arguments; other extras are
    accepted and unused, as in the JAX package. `eval_folder` builds the
    eval set, which `val_dataloader` returns (None without one)."""

    train_cls = VideoTrainDataset
    tar_cls = TarShardVideoDataset
    TAR_KEYS = ("degradation_opt", "shuffle_shards", "process_index", "process_count")

    def __init__(self, base_folder: str, eval_folder: Optional[str] = None, width: int = 512,
                 height: int = 512, sample_frames: int = 16, batch_size: int = 1,
                 num_workers: int = 4, seed: int = 0, **kwargs):
        self.base_folder = base_folder
        self.eval_folder = eval_folder
        self.width, self.height = int(width), int(height)
        self.sample_frames = int(sample_frames)
        self.batch_size = int(batch_size)
        self.num_workers = int(num_workers)
        self.seed = int(seed)
        self.extra = kwargs
        self.train_dataset = None
        self.val_dataset: Optional[SyncDreamerEvalData] = None

    def _folder_dataset(self):
        return self.train_cls(self.base_folder, self.width, self.height, self.sample_frames)

    def setup(self) -> "VideoDataset":
        if ".tar" in str(self.base_folder):
            self.train_dataset = self.tar_cls(
                self.base_folder, self.width, self.height, self.sample_frames, seed=self.seed,
                **{k: v for k, v in self.extra.items() if k in self.TAR_KEYS})
        else:
            self.train_dataset = self._folder_dataset()
        if self.eval_folder:
            self.val_dataset = SyncDreamerEvalData(self.eval_folder)
        return self

    def train_dataloader(self) -> Iterator[Dict]:
        """The training batches of this process: its loader is seeded
        `seed + rank`, as JAX's `seed + process_index`."""
        if self.train_dataset is None:
            self.setup()
        return iter(PrefetchLoader(self.train_dataset, self.batch_size,
                                   seed=self.seed + pdist.rank(), num_workers=self.num_workers))

    def val_dataloader(self) -> Optional[SyncDreamerEvalData]:
        if self.val_dataset is None:
            self.setup()
        return self.val_dataset


class VideoDatasetStage2(VideoDataset):
    """The `data:` section of train-v02.yaml: `VideoTrainDatasetStage2`, or
    `TarShardVideoDatasetStage2` on shards; `degradation_opt` overrides the
    kernels' Real-ESRGAN settings for either (the JAX package passes it to
    the tar dataset only), `depth_folder` is accepted and unused."""

    train_cls = VideoTrainDatasetStage2
    tar_cls = TarShardVideoDatasetStage2

    def _folder_dataset(self):
        return self.train_cls(self.base_folder, self.width, self.height, self.sample_frames,
                              degradation_opt=self.extra.get("degradation_opt"))
