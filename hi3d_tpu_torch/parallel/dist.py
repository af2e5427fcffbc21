"""The process group of a multi-GPU run (counterpart of the JAX CLI's
distributed initialisation, train.py:78-88, and of the "data" axis of
hi3d_tpu/parallel/mesh.py's `get_mesh`).

One process per GPU, started by torchrun, which sets `RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`:

    torchrun --nproc_per_node N -m hi3d_tpu_torch.train --base configs/train-v01.yaml

`init` reads them and joins the group: NCCL for a CUDA device (the process
takes `cuda:LOCAL_RANK`), gloo for the CPU. Without `WORLD_SIZE` it does
nothing and the run is one process (world 1). With `WORLD_SIZE` set, a group
that cannot be joined is an error: there is no fallback to another backend or
to one process.

Serving (pipelines/serve.py) adds what frame-parallel inference needs:
sub-groups (`new_group`), `FrameShard` (which rows of a B·T frame batch this
rank holds, the regroup between that frame-split layout and the
location-split one, the gather of the per-frame embedding and the
combination of split GroupNorm moments), `gather_rows` (decoded frames to
the rank that writes) and `send_tensor` / `recv_tensor` (a batch of videos
handed from one sub-group to the other). A CUDA tensor in a gloo group (two
processes on one card) goes through host memory inside gloo's collectives;
torch 2.11's gloo takes CUDA tensors in all_reduce, broadcast, all_gather,
all_gather_into_tensor, all_to_all_single, gather and reduce_scatter_tensor,
but its send and recv abort the process on a CUDA pointer, so `send_tensor`
and `recv_tensor` stage through host memory there.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)  # a collective that waits longer raises


def init(device: str = "cuda") -> Tuple[torch.device, bool]:
    """(this process's device, whether this call created the group).

    Under torchrun (`WORLD_SIZE` set) joins the group from the environment,
    unless one is already initialised; a CUDA `device` becomes
    `cuda:LOCAL_RANK` and is made current. Otherwise returns `device` as
    given and creates nothing."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev, False
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if initialized():
        return dev, False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            timeout=TIMEOUT,
                            device_id=dev if dev.type == "cuda" else None)
    return dev, True


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in `group` (the world by default); 0 in one process."""
    return dist.get_rank(group) if initialized() else 0


def world(group=None) -> int:
    """The ranks of `group` (the world by default); 1 in one process."""
    return dist.get_world_size(group) if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of a tensor over the ranks (the tensor itself in one
    process)."""
    if not initialized():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / world()


def any_over_ranks(flag: bool, device: torch.device, group=None) -> bool:
    """True on every rank of `group` (the world by default) when `flag` is
    true on some rank of it."""
    if not initialized():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def broadcast_module(module: torch.nn.Module, group=None) -> None:
    """The parameters and buffers of the group's first rank (rank 0 of the
    world by default), copied to every rank of `group`."""
    if not initialized():
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in module.state_dict(keep_vars=True).values():
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=src,
                           group=group)


def broadcast_object(obj):
    """Rank 0's value of a picklable object, on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ------------------------------------------------------------------ serving
def new_group(ranks: Sequence[int]):
    """A sub-group of the world's `ranks`. Every rank of the world must call
    this, with the same ranks, in the same order."""
    return dist.new_group(sorted(ranks), timeout=TIMEOUT)


def _blocks(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of `parts` near-equal blocks of range(n)."""
    return [(n * r // parts, n * (r + 1) // parts) for r in range(parts)]


@dataclass(frozen=True)
class FrameShard:
    """The rows of a batch of `total` = B·T frames (B videos of `frames`
    frames, video-major) that this rank holds: [offset, offset + count). A
    model batch may hold several copies of those rows (CFG's unconditioned
    and conditioned halves): copy j is rows j·total + [offset, offset +
    count) of the copies stacked, and every rank holds the same copies.

    `group` is the process group whose ranks hold the other rows, in rank
    order; the frame-parallel UNet (latency mode) regroups over it. Rows
    may straddle videos. Without a group (one rank, or throughput mode,
    where each rank holds whole videos and nothing crosses ranks inside the
    UNet) only the row bookkeeping applies: the noise draws and the
    guider's frame index."""

    frames: int
    total: int
    offset: int
    count: int
    group: Any = None

    @classmethod
    def split(cls, videos: int, frames: int, group=None, whole_videos: bool = False):
        """This rank's share of `videos` × `frames` rows over `group`: equal
        blocks of rows, or with `whole_videos` of videos (throughput mode:
        the shard then carries no group)."""
        w, r = world(group), rank(group)
        total = videos * frames
        unit = frames if whole_videos else 1
        if (total // unit) % w:
            raise ValueError(f"{videos} videos × {frames} frames do not split into {w} equal "
                             f"blocks of {'videos' if whole_videos else 'frames'}")
        count = total // w
        return cls(frames, total, r * count, count, None if whole_videos else group)

    @property
    def videos(self) -> int:
        return self.total // self.frames

    @property
    def world(self) -> int:
        return world(self.group) if self.group is not None else 1

    @property
    def rank(self) -> int:
        return rank(self.group) if self.group is not None else 0

    def copies(self, rows: int) -> int:
        """The copies of this rank's rows in a model batch of `rows` rows."""
        k, rest = divmod(rows, self.count)
        if rest or not k:
            raise ValueError(f"a batch of {rows} rows is not copies of this rank's "
                             f"{self.count} frames")
        return k

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (total, ...) tensor."""
        if full.shape[0] != self.total:
            raise ValueError(f"{full.shape[0]} rows, the batch has {self.total}")
        return full[self.offset:self.offset + self.count]

    def randn(self, shape, generator=None, device=None, dtype=torch.float32) -> torch.Tensor:
        """The rows of one process's draw of unit normals of `shape` ((total,
        ...)) from `generator` that this rank holds: every rank draws the
        whole batch and keeps its rows, so the numbers are one process's."""
        return self.take(torch.randn(tuple(shape), generator=generator, device=device,
                                     dtype=dtype))

    def take_cond(self, cond: dict) -> dict:
        """This rank's part of a conditioning dict of the whole batch: an entry
        of B·T rows (per frame) → this rank's rows; one of B rows (per
        video) → this rank's videos without a group (throughput), all of
        them with one (the frame-parallel UNet indexes them per row)."""
        out = {}
        for key, v in cond.items():
            if not isinstance(v, torch.Tensor) or v.ndim == 0:
                out[key] = v
            elif v.shape[0] == self.total:
                out[key] = self.take(v)
            elif v.shape[0] == self.videos:
                out[key] = v if self.group is not None else v[
                    self.offset // self.frames:(self.offset + self.count) // self.frames]
            else:
                raise ValueError(f"conditioning {key!r} has {v.shape[0]} rows: neither the "
                                 f"batch's {self.total} frames nor its {self.videos} videos")
        return out

    def rows(self, copies: int, device=None) -> torch.Tensor:
        """The batch rows (int64) of this rank's `copies` copies."""
        local = torch.arange(self.count, device=device) + self.offset
        return (torch.arange(copies, device=device)[:, None] * self.total + local).reshape(-1)

    def frame_index(self, copies: int = 1, device=None) -> torch.Tensor:
        """The frame (0 … T−1, within its video) of each of this rank's rows."""
        return self.rows(copies, device) % self.frames

    def video_index(self, copies: int = 1, device=None) -> torch.Tensor:
        """The video (0 … copies·B−1) of each of this rank's rows."""
        return self.rows(copies, device) // self.frames

    def location_block(self, locations: int) -> Tuple[int, int]:
        """[start, stop) of the locations this rank holds in the
        location-split layout."""
        return _blocks(locations, self.world)[self.rank]

    def to_locations(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Frame-split → location-split: x is (k·count, ...), this rank's rows
        of k copies with the flattened locations along `dim`; the result is
        (k·total, ...), every row of the batch, `dim` cut to this rank's
        block of the locations (`location_block`, near-equal blocks in rank
        order). One all_to_all."""
        w, r = self.world, self.rank
        k = self.copies(x.shape[0])
        xm = x.movedim(dim, 1)
        rest = xm.shape[2:]
        per = math.prod(rest)
        if xm.shape[1] < w:
            raise ValueError(f"{xm.shape[1]} locations cannot be split over {w} ranks")
        blocks = _blocks(xm.shape[1], w)
        send = torch.cat([xm[:, a:b].reshape(-1) for a, b in blocks])
        size = blocks[r][1] - blocks[r][0]
        out = x.new_empty(w * k * self.count * size * per)
        dist.all_to_all_single(out, send, [k * self.count * size * per] * w,
                               [k * self.count * (b - a) * per for a, b in blocks],
                               group=self.group)
        y = out.view(w, k, self.count, size, *rest).transpose(0, 1)
        return y.reshape(k * self.total, size, *rest).movedim(1, dim)

    def to_frames(self, y: torch.Tensor, dim: int, locations: int) -> torch.Tensor:
        """Location-split → frame-split, `to_locations` undone: y is
        (k·total, ...) with this rank's block of the `locations` along
        `dim`; the result is (k·count, ...) with every location. One
        all_to_all."""
        w = self.world
        ym = y.movedim(dim, 1)
        k = ym.shape[0] // self.total
        size, rest = ym.shape[1], ym.shape[2:]
        per = math.prod(rest)
        blocks = _blocks(locations, w)
        send = ym.reshape(k, w, self.count, size, *rest).transpose(0, 1).reshape(-1)
        splits = [k * self.count * (b - a) * per for a, b in blocks]
        out = y.new_empty(sum(splits))
        dist.all_to_all_single(out, send, splits, [k * self.count * size * per] * w,
                               group=self.group)
        parts = [part.view(k * self.count, b - a, *rest)
                 for part, (a, b) in zip(out.split(splits), blocks)]
        return torch.cat(parts, dim=1).movedim(1, dim)

    def gather_frames(self, x: torch.Tensor) -> torch.Tensor:
        """(k·count, ...) rows of this rank → (k·total, ...) every row, on
        every rank. One all_gather."""
        w = self.world
        k = self.copies(x.shape[0])
        out = x.new_empty((w * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        out = out.view(w, k, self.count, *x.shape[1:]).transpose(0, 1)
        return out.reshape(k * self.total, *x.shape[1:])

    def combine_moments(self, mean: torch.Tensor, m2: torch.Tensor, count: int,
                        eps: float) -> torch.Tensor:
        """Statistics of groups split over the ranks: each rank's (N, G)
        (mean, M2 = Σ(x − mean)²) of its `count` elements a group →
        (2, N, G) fp32 (mean, inv_std = rsqrt(var + eps)) of the whole
        groups, the same on every rank. One all_gather of (count, mean, M2)
        in float64; the ranks' moments fold in rank order by Chan's
        pairwise formula."""
        w = self.world
        local = torch.stack([torch.full_like(mean, float(count)), mean, m2]).double()
        parts = local.new_empty((w * 3,) + tuple(mean.shape))
        dist.all_gather_into_tensor(parts, local.contiguous(), group=self.group)
        parts = parts.view(w, 3, *mean.shape)
        n_a, mean_a, m2_a = parts[0].unbind(0)
        for q in range(1, w):
            n_b, mean_b, m2_b = parts[q].unbind(0)
            n = n_a + n_b
            delta = mean_b - mean_a
            frac = n_b / n
            mean_a = mean_a + delta * frac
            m2_a = m2_a + m2_b + delta * delta * n_a * frac
            n_a = n
        var = m2_a / n_a
        return torch.stack([mean_a, torch.rsqrt(var + eps)]).float().contiguous()


def gather_rows(x: torch.Tensor, dst: int = 0, group=None) -> Optional[torch.Tensor]:
    """Every rank's x (the same shape on each), stacked along dim 0 in rank
    order on the group's rank `dst`; None on the other ranks. x itself in
    one process."""
    if not initialized() or world(group) == 1:
        return x
    x = x.contiguous()
    w = world(group)
    root = dist.get_global_rank(group, dst) if group is not None else dst
    parts = [torch.empty_like(x) for _ in range(w)] if rank(group) == dst else None
    dist.gather(x, parts, dst=root, group=group)
    return torch.cat(parts) if parts is not None else None


def _staged(t: torch.Tensor, group=None) -> bool:
    """Whether point-to-point traffic of `t` must go through host memory:
    a CUDA tensor in a gloo group (gloo's send and recv take host
    pointers only)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def send_tensor(x: torch.Tensor, dst: int, group=None) -> None:
    """x to the world's rank `dst`: a header (ndim, shape, dtype code), then
    the data. Received by `recv_tensor`."""
    codes = [torch.float32, torch.bfloat16, torch.float16, torch.uint8, torch.int64]
    header = torch.tensor([x.ndim, codes.index(x.dtype), *x.shape] + [0] * (8 - x.ndim),
                          dtype=torch.int64)
    header = header if _staged(x, group) or not x.is_cuda else header.to(x.device)
    dist.send(header, dst, group=group)
    data = x.contiguous()
    dist.send(data.cpu() if _staged(data, group) else data, dst, group=group)


def recv_tensor(src: int, device, group=None) -> torch.Tensor:
    """A tensor sent by `send_tensor` from the world's rank `src`, on
    `device`."""
    codes = [torch.float32, torch.bfloat16, torch.float16, torch.uint8, torch.int64]
    device = torch.device(device)
    host = device.type == "cpu" or dist.get_backend(group) == "gloo"
    header = torch.empty(10, dtype=torch.int64, device="cpu" if host else device)
    dist.recv(header, src, group=group)
    ndim, code, *shape = header.tolist()
    out = torch.empty(shape[:ndim], dtype=codes[code], device="cpu" if host else device)
    dist.recv(out, src, group=group)
    return out.to(device)
