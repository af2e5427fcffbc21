"""Batched serving on one GPU or over a torchrun group (counterpart of
hi3d_tpu/pipelines/serve.py).

    python -m hi3d_tpu_torch.pipelines.serve --image_dir <images> --output_dir <out> \\
        --batch 2 --clip_size 48
    python -m hi3d_tpu_torch.pipelines.serve --image_dir <images> --output_dir <out> \\
        --mode two_stage --batch 1
    torchrun --nproc_per_node 4 -m hi3d_tpu_torch.pipelines.serve --image_dir <images> \\
        --output_dir <out> --batch 4     # throughput: each GPU takes one whole asset
    torchrun --nproc_per_node 4 -m hi3d_tpu_torch.pipelines.serve --image_dir <images> \\
        --output_dir <out> --batch 1     # latency: each GPU takes 4 of the 16 frames

`OrbitServer` turns B object images into B orbit videos with one conditioner
pass over the B assets, one sampler run over the (B·T) frames (the UNet sees
B videos, CFG-doubled) and a chunked VAE decode. `RefineServer` runs stage
2's latent-blending refinement (`v2v.blend_refine_batch`) on B videos.
`TwoStageServer` runs stage 1 then stage 2: on one GPU with both engines
resident, stage 1 of batch N+1 in a producer thread while stage 2 refines
batch N; over a group, each stage on its own sub-group of ranks, the two
overlapping as processes. `main` is the CLI: a directory of images → per
asset `<name>/frames/NNN.png` and the H.264 `<name>/orbit.mp4`; `--mode orbit` writes stage 1's orbits, `--mode two_stage` stage
2's refined views at `--stage2_resolution`.

Over a group of W ranks (one process a GPU, `parallel.dist.init`), a server
gives the result of one process: the same images, seed and flags give the
same videos, up to summation order. Every rank conditions the whole batch
and draws the whole batch's noise from the same seeded generator, keeping
its rows (`parallel.dist.FrameShard`); the decoded frames are gathered to
the group's first rank, which returns the videos, and the other ranks
return None. As JAX's servers, a batch takes one of two modes:

- throughput (B % W == 0): each rank takes B/W whole assets; nothing
  crosses ranks inside the UNet;
- latency (otherwise, when (B·T) % W == 0): each rank takes a block of the
  B·T frames, which may straddle assets, and the UNet runs frame-parallel
  (`models/unet.py`). Sharding frames needs collectives wherever the
  network or the sampler reads more than one frame, not only at the
  temporal attention's regroup, as JAX's docstrings say: every time-stack
  ResBlock (its (3, 1, 1) convolution and its GroupNorms' statistics span
  the frames), the positional embedding and the per-frame CFG guider
  (each row's frame within its video) and every noise draw (the initial
  noise, the blend loop's, the ancestral and churn steps': one process's
  numbers for the rank's rows);
- neither: a ValueError naming B, T and W.

`mode="latency"` or `"throughput"` (`--parallel`) forces a mode where it
divides; at W = 1 a forced latency mode runs the frame-parallel code with
the regroups as identities.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import dist
from ..utils.image import load_image_rgb, resize_center_crop
from ..utils.video import denorm_to_uint8, export_to_video, tensor2vid
from .common import add_turbo_arguments
from .i2v import UC_ZERO_KEYS, PhaseTimer

MODES = ("auto", "throughput", "latency")


class _Sharded:
    """What both servers share over a group: the first rank's weights on
    every rank (a collective: every rank of the group builds its server),
    the batch's split, the finiteness check and the gather of the decoded
    frames to the group's first rank (the writer)."""

    def __init__(self, model, group=None, mode: str = "auto"):
        if mode not in MODES:
            raise ValueError(f"unknown serving mode {mode!r} (one of {MODES})")
        self.model = model
        if group is None and dist.initialized():
            group = torch.distributed.group.WORLD
        self.group = group
        self.mode = mode
        if self.world > 1:
            dist.broadcast_module(model, group)

    @property
    def world(self) -> int:
        return dist.world(self.group) if self.group is not None else 1

    @property
    def is_writer(self) -> bool:
        return self.group is None or dist.rank(self.group) == 0

    def frames(self, b: int, t: int) -> Optional[dist.FrameShard]:
        """This rank's rows of B videos × T frames, or None at W = 1 (the
        one-process path) unless latency is forced."""
        w, mode = self.world, self.mode
        if w == 1 and mode != "latency":
            return None
        if mode == "auto":
            if b % w and (b * t) % w:
                raise ValueError(f"batch×frames {b}·{t} not divisible by the {w} ranks")
            mode = "throughput" if b % w == 0 else "latency"
        return dist.FrameShard.split(b, t, self.group, whole_videos=mode == "throughput")

    def finish(self, decoded: torch.Tensor, frames, shape, output_dtype: str, timer):
        """Decoded rows → the (B, T, H, W, 3) numpy videos on the writer
        (None elsewhere): the finiteness check on every rank, the uint8 or
        clamped float conversion, the gather to the writer. Without a group
        the rows are this process's whole videos."""
        bad = not bool(torch.isfinite(decoded).all())
        if frames is not None:
            bad = dist.any_over_ranks(bad, decoded.device, self.group)
        if bad:
            raise FloatingPointError("VAE decode produced non-finite values")
        timer.mark("vae_decode")
        out = denorm_to_uint8(decoded) if output_dtype == "uint8" else decoded.clamp(-1.0, 1.0)
        if frames is not None:
            out = dist.gather_rows(out, 0, self.group)
            timer.mark("gather")
        if out is None:
            return None
        out = out.cpu().numpy().reshape((-1,) + tuple(shape[1:]))
        timer.mark("to_host")
        return out


class OrbitServer(_Sharded):
    """Stage-1 multi-asset orbit generation on the model's device, or over
    the ranks of `group` (the world's when a group is initialised)."""

    @torch.no_grad()
    def condition(self, images: np.ndarray, elevations: Optional[Sequence[float]] = None,
                  generator: Optional[torch.Generator] = None,
                  batch_overrides: Optional[Dict] = None):
        """One conditioner pass over the B assets → (c, uc), the frame keys
        zeroed in uc."""
        model = self.model
        b, h, w, _ = images.shape
        t = model.num_samples
        device = model.device
        x = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
        batch: Dict = {
            "video": x.permute(0, 3, 1, 2)[:, None].expand(b, t, 3, h, w),
            "elevation": torch.tensor(list(elevations) if elevations is not None else [0.0] * b,
                                      dtype=torch.float32, device=device),
        }
        batch = model.add_custom_cond(batch, infer=True, generator=generator)
        if batch_overrides:
            batch.update(batch_overrides)
        return model.conditioner.get_unconditional_conditioning(
            batch, force_uc_zero_embeddings=list(UC_ZERO_KEYS)
        )

    @torch.no_grad()
    def generate(
        self,
        images: np.ndarray,  # (B, H, W, 3) in [-1, 1]
        elevations: Optional[Sequence[float]] = None,
        generator: Optional[torch.Generator] = None,
        randn=None,  # (B·T, H/8, W/8, 4) unit noise
        batch_overrides: Optional[Dict] = None,  # applied after add_custom_cond
        encoder_reuse: int = 0,  # turbo (approximate; 0 = exact)
        cfg_interval=None,  # (lo, hi): CFG only where σ ∈ [lo, hi] (turbo)
        output_dtype: str = "float32",
        timer: Optional[PhaseTimer] = None,
    ) -> Optional[np.ndarray]:
        """→ (B, T, H, W, 3), float32 in [-1, 1] or uint8 (`output_dtype`),
        on the writer; None on the group's other ranks. Every rank of the
        group calls it with the same arguments."""
        model = self.model
        b, h, w, _ = images.shape
        t = model.num_samples
        frames = self.frames(b, t)
        timer = timer or PhaseTimer(model.device)
        c, uc = self.condition(images, elevations, generator, batch_overrides)
        if frames is not None:
            c, uc = frames.take_cond(c), frames.take_cond(uc)
        timer.mark("conditioner")
        samples = model.sample(cond=c, uc=uc, shape=(b * t, h // 8, w // 8, 4),
                               num_video_frames=t, generator=generator, randn=randn,
                               encoder_reuse=encoder_reuse, cfg_interval=cfg_interval,
                               frames=frames)
        timer.mark("sampler")
        return self.finish(model.decode_first_stage(samples), frames, (b, t, h, w, 3),
                           output_dtype, timer)


def fold_generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on `device` for stream `stream` of `seed`: the same pair
    always gives the same numbers, different pairs independent ones (JAX's
    fold_in(PRNGKey(seed), stream))."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class RefineServer(_Sharded):
    """Stage-2 latent-blending refinement of B videos on the model's device
    (the B·T frames in one blend loop), or over the ranks of `group`."""

    def refine(self, videos, elevations: Optional[Sequence[float]] = None,
               masks: Optional[np.ndarray] = None,
               generator: Optional[torch.Generator] = None, init_noise=None,
               batch_overrides: Optional[Dict] = None, encoder_reuse: int = 0,
               cfg_interval=None, output_dtype: str = "float32",
               timer: Optional[PhaseTimer] = None) -> Optional[np.ndarray]:
        """videos (B, T, H, W, 3), uint8 or [-1, 1] float, numpy or a tensor →
        (B, T, H, W, 3), float32 in [-1, 1] or uint8 (`output_dtype`), on the
        writer; None on the group's other ranks."""
        from .v2v import blend_refine_batch

        b, t = videos.shape[:2]
        frames = self.frames(b, t)
        kw = dict(masks=masks, elevations=elevations, generator=generator, init_noise=init_noise,
                  batch_overrides=batch_overrides, encoder_reuse=encoder_reuse,
                  cfg_interval=cfg_interval, output_dtype=output_dtype, timer=timer)
        if frames is None:
            return blend_refine_batch(self.model, videos, **kw)
        timer = timer or PhaseTimer(self.model.device)
        decoded = blend_refine_batch(self.model, videos, frames=frames, **{**kw, "timer": timer})
        return self.finish(decoded, frames, (b, t) + tuple(decoded.shape[1:]), output_dtype,
                           timer)


def stage_ranks(world: int, stage1_ranks=None, stage2_ranks=None):
    """(stage-1 ranks, stage-2 ranks) of a `world`-rank group, as JAX's
    TwoStageServer splits its devices: power-of-two halves by default (the
    first p ranks, then the next p, p the largest power of two ≤ world/2;
    any rank past 2p idles), both stages on the one rank at world 1; one
    side given, the other is the rest. Disjoint past world 1."""
    ranks = list(range(world))
    if world == 1:
        return [0], [0]
    if stage1_ranks is None and stage2_ranks is None:
        half = max(1, world // 2)
        p = 1 << (half.bit_length() - 1)
        stage1_ranks, stage2_ranks = ranks[:p], ranks[p:2 * p]
    elif stage1_ranks is None:
        stage1_ranks = [r for r in ranks if r not in set(stage2_ranks)]
    elif stage2_ranks is None:
        stage2_ranks = [r for r in ranks if r not in set(stage1_ranks)]
    stage1_ranks, stage2_ranks = sorted(stage1_ranks), sorted(stage2_ranks)
    if not stage1_ranks or not stage2_ranks or set(stage1_ranks) & set(stage2_ranks) or not set(
            stage1_ranks + stage2_ranks) <= set(ranks):
        raise ValueError(f"stage ranks {stage1_ranks} and {stage2_ranks} must be disjoint, "
                         f"non-empty ranks of the {world}-rank group")
    return stage1_ranks, stage2_ranks


# the codes of the two-stage handoff: a batch follows, the stream ended, the
# sending side failed
_BATCH, _END, _FAILED = 1, 0, -1


class TwoStageServer:
    """Stage 1 then stage 2.

    In one process (world 1) both engines are resident on the one card and
    `generate_stream` overlaps stage 1 of batch N+1 (a producer thread) with
    stage 2 of batch N. Over a group each stage runs on its own sub-group
    (`stage_ranks`; the servers' frame split within each), every rank
    builds both sub-groups, and a rank holds only its own stage's model
    (the other may be None): stage 1's first rank hands each batch's videos
    to every stage-2 rank and goes on with the next batch while stage 2
    refines. Each batch `i` draws its noise from its own generators, streams
    2i and 2i+1 of the seed (`stage_generators`), so the outputs do not
    depend on how the stages interleave. A failure on either side raises on
    every rank of both stages (the handoff carries a failure code each
    way); the group's TIMEOUT is the last guard."""

    def __init__(self, stage1_model, stage2_model, stage1_ranks=None, stage2_ranks=None,
                 mode: str = "auto"):
        world = dist.world()
        self.ranks = stage_ranks(world, stage1_ranks, stage2_ranks)
        groups = ([dist.new_group(r) for r in self.ranks] if dist.initialized()
                  else [None, None])
        me = dist.rank()
        self.orbit = (OrbitServer(stage1_model, groups[0], mode) if me in self.ranks[0]
                      else None)
        self.refine = (RefineServer(stage2_model, groups[1], mode) if me in self.ranks[1]
                       else None)

    @property
    def writer(self) -> int:
        """The world rank that returns the refined videos: stage 2's first."""
        return self.ranks[1][0]

    @staticmethod
    def _generator(server, seed: int, stream: int):
        return None if server is None else fold_generator(server.model.device, seed, stream)

    def stage_generators(self, seed: int, i: int):
        """(stage-1, stage-2) generators of batch `i` (None for a stage
        this rank does not run)."""
        return (self._generator(self.orbit, seed, 2 * i),
                self._generator(self.refine, seed, 2 * i + 1))

    @staticmethod
    def _to_stage2_res(videos, stage2_hw, device=None):
        """(B, T, H, W, 3) float videos → a tensor on `device` at `stage2_hw`:
        half-pixel bilinear without antialiasing (cv2.resize INTER_LINEAR
        on float frames, as the JAX server resizes)."""
        x = videos if isinstance(videos, torch.Tensor) else torch.as_tensor(np.asarray(videos))
        x = x.to(device)
        if stage2_hw is None or tuple(stage2_hw) == tuple(x.shape[2:4]):
            return x
        b, t, h, w, c = x.shape
        y = F.interpolate(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), size=tuple(stage2_hw),
                          mode="bilinear", align_corners=False, antialias=False)
        return y.permute(0, 2, 3, 1).reshape(b, t, *stage2_hw, c)

    def _stage2(self, videos, elevations, generator, stage2_hw, turbo, output_dtype, timer):
        videos = self._to_stage2_res(videos, stage2_hw, self.refine.model.device)
        return self.refine.refine(videos, elevations=elevations, generator=generator,
                                  output_dtype=output_dtype, timer=timer, **turbo)

    def generate(self, images: np.ndarray, elevations: Optional[Sequence[float]] = None,
                 generators=None, stage2_hw: Optional[Sequence[int]] = None,
                 encoder_reuse: int = 0, cfg_interval=None, output_dtype: str = "float32",
                 timers=(None, None)) -> np.ndarray:
        """images (B, H1, W1, 3) in [-1, 1] → refined (B, T, H2, W2, 3);
        `generators` is a (stage 1, stage 2) pair, batch 0 of seed 0 by
        default; the turbo modes apply to both stages. One process (both
        stages on this rank) only: over a group, `generate_stream`."""
        if self.orbit is None or self.refine is None:
            raise ValueError("TwoStageServer.generate runs both stages in one process; over a "
                             "group use generate_stream")
        turbo = dict(encoder_reuse=encoder_reuse, cfg_interval=cfg_interval)
        g1, g2 = generators or self.stage_generators(0, 0)
        videos = self.orbit.generate(images, elevations=elevations, generator=g1, timer=timers[0],
                                     **turbo)
        return self._stage2(videos, elevations, g2, stage2_hw, turbo, output_dtype, timers[1])

    def generate_stream(self, batches, elevations=None, seed: int = 0,
                        stage2_hw: Optional[Sequence[int]] = None, encoder_reuse: int = 0,
                        cfg_interval=None, output_dtype: str = "float32",
                        timers=(None, None)):
        """Yield the refined videos of each batch of `batches`, in order
        (over a group: on the writer, None on every other rank, one item a
        batch on every rank; every rank passes the same batches).
        `elevations` is a scalar for every asset (batches may then differ in
        size) or a per-asset list applied to every batch (which must then
        all have its length). In one process stage 1 of the next batch runs
        in a producer thread meanwhile (a handoff queue of one); a
        producer's exception is raised here, and when the consumer stops
        early the producer is stopped and joined."""
        turbo = dict(encoder_reuse=encoder_reuse, cfg_interval=cfg_interval)
        if np.isscalar(elevations):
            scalar_elev, elevations = float(elevations), None
        else:
            scalar_elev = None
            if elevations is not None:
                elevations = list(elevations)

        def _elev(b: int):
            if scalar_elev is not None:
                return [scalar_elev] * b
            if elevations is None:
                return None
            if len(elevations) != b:
                raise ValueError(
                    f"per-asset elevations has {len(elevations)} entries but this batch has {b} "
                    "assets — a list applies to every batch; pass a scalar for variable-size "
                    "batches")
            return elevations

        args = (batches, _elev, seed, stage2_hw, turbo, output_dtype, timers)
        if self.orbit is not None and self.refine is not None:
            return self._threaded_stream(*args)
        if self.orbit is not None:
            return self._stage1_stream(*args)
        if self.refine is not None:
            return self._stage2_stream(*args)
        return (None for _ in batches)  # a rank past both stages' sub-groups idles

    def _threaded_stream(self, batches, _elev, seed, stage2_hw, turbo, output_dtype, timers):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()
        err = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for i, images in enumerate(batches):
                    if stop.is_set():
                        return
                    g1, g2 = self.stage_generators(seed, i)
                    elev = _elev(len(images))
                    if timers[0] is not None:
                        timers[0].mark("wait")
                    videos = self.orbit.generate(images, elevations=elev, generator=g1,
                                                 timer=timers[0], **turbo)
                    if not _put((videos, elev, g2)):
                        return
            except Exception as e:  # raised by the consumer
                err.append(e)
            finally:
                _put(None)

        t = threading.Thread(target=producer, name="serve-stage1-producer", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                videos, elev, g2 = item
                if timers[1] is not None:
                    timers[1].mark("wait")
                yield self._stage2(videos, elev, g2, stage2_hw, turbo, output_dtype, timers[1])
        finally:
            stop.set()
            t.join(timeout=30)
            if t.is_alive():
                # a stage-1 batch in flight cannot be interrupted: it finishes,
                # sees `stop`, and exits
                print("[serve] stage-1 producer still finishing its current batch")
        if err:
            raise err[0]

    def _code(self, code: int, device) -> torch.Tensor:
        return torch.tensor([code], dtype=torch.int64, device=device)

    def _tell_failed(self, ranks, device) -> None:
        """The failure code to each of `ranks`, as far as it can go: a rank
        whose process has already ended cannot take it, and its peers'
        collectives fail on their own."""
        for dst in ranks:
            try:
                dist.send_tensor(self._code(_FAILED, device), dst)
            except RuntimeError as e:
                print(f"[serve] could not tell rank {dst} of the failure: {e}")

    def _stage1_stream(self, batches, _elev, seed, stage2_hw, turbo, output_dtype, timers):
        """A stage-1 rank: generate each batch on the stage-1 sub-group; the
        first rank waits for stage 2's word on the batch before (so one
        batch is in flight on each side), tells its sub-group, and hands
        the videos to every stage-2 rank."""
        leader, device = self.ranks[0][0], self.orbit.model.device
        lead = dist.rank() == leader
        pending = False  # a batch handed over whose word has not come back

        def word_from_stage2() -> None:
            code = self._code(0, device)
            if lead:
                code = dist.recv_tensor(self.writer, device)
            torch.distributed.broadcast(code, leader, group=self.orbit.group)
            if int(code.item()) == _FAILED:
                raise RuntimeError("[serve] stage 2 failed on its ranks")

        try:
            for i, images in enumerate(batches):
                g1, _ = self.stage_generators(seed, i)
                if timers[0] is not None:
                    timers[0].mark("wait")
                videos = self.orbit.generate(images, elevations=_elev(len(images)), generator=g1,
                                             timer=timers[0], **turbo)
                if pending:
                    word_from_stage2()
                if lead:
                    for dst in self.ranks[1]:
                        dist.send_tensor(self._code(_BATCH, device), dst)
                        dist.send_tensor(torch.from_numpy(videos).to(device), dst)
                pending = True
                yield None
            if pending:
                word_from_stage2()
            if lead:
                for dst in self.ranks[1]:
                    dist.send_tensor(self._code(_END, device), dst)
        except BaseException:
            if lead:  # stage 2 must not wait for a batch that will not come
                self._tell_failed(self.ranks[1], device)
            raise

    def _stage2_stream(self, batches, _elev, seed, stage2_hw, turbo, output_dtype, timers):
        """A stage-2 rank: take each batch from stage 1's first rank and
        refine it on the stage-2 sub-group; the writer sends stage 1 the
        word on each batch (done, or failed)."""
        leader, device = self.ranks[0][0], self.refine.model.device
        writes = dist.rank() == self.writer
        for i, images in enumerate(batches):
            code = int(dist.recv_tensor(leader, device).item())
            if code != _BATCH:
                raise RuntimeError("[serve] stage 1 failed on its ranks" if code == _FAILED
                                   else f"[serve] stage 1 ended after {i} of the batches")
            videos = dist.recv_tensor(leader, device)
            _, g2 = self.stage_generators(seed, i)
            if timers[1] is not None:
                timers[1].mark("wait")
            try:
                out = self._stage2(videos, _elev(len(images)), g2, stage2_hw, turbo,
                                   output_dtype, timers[1])
            except BaseException:
                if writes:
                    self._tell_failed([leader], device)
                raise
            if writes:
                dist.send_tensor(self._code(_BATCH, device), leader)
            yield out
        if int(dist.recv_tensor(leader, device).item()) != _END:
            raise RuntimeError("[serve] stage 1 failed after its last batch")


def load_images(paths: Sequence[str], resolution) -> np.ndarray:
    """(N, H, W, 3) float32 in [-1, 1]: each image resized and center-cropped."""
    return np.stack([
        (resize_center_crop(load_image_rgb(q), tuple(resolution)).astype(np.float32) / 255.0
         - 0.5) * 2.0
        for q in paths
    ])


def _unique_names(paths: Sequence[str]) -> List[str]:
    """File stems, de-duplicated (a.png and a.jpg must not share an output
    directory) by appending the extension and then an index if still
    colliding."""
    names, seen = [], set()
    for q in paths:
        base = os.path.basename(q)
        name = os.path.splitext(base)[0]
        if name in seen:
            name = base.replace(".", "_")
        stem, i = name, 1
        while name in seen:
            name, i = f"{stem}_{i}", i + 1
        seen.add(name)
        names.append(name)
    return names


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Batch-serving CLI: a directory of images → one orbit per image (stage
    1, `--mode orbit`) or one refined set of views (both stages, `--mode
    two_stage`), in one process or over the torchrun group it joins
    (`parallel.dist.init`). Returns {"outputs": paths this rank wrote,
    "phases": seconds per phase on this rank (two_stage: `stage1_*` and
    `stage2_*`, the two stages overlapping), "batches": batches run,
    "rank": this rank}."""
    p = argparse.ArgumentParser(description="Hi3D batched serving (PyTorch port): one GPU, or "
                                            "one process a GPU under torchrun")
    p.add_argument("--image_dir", required=True,
                   help="directory of input images (png, jpg/jpeg, webp)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mode", default="orbit", choices=["orbit", "two_stage"])
    p.add_argument("--batch", type=int, default=0,
                   help="assets per batch (default: one batch of all images); a smaller final "
                        "batch is padded with its last image, and the padded outputs are dropped")
    p.add_argument("--stage1_config", default="configs/inference-v01.yaml")
    p.add_argument("--stage1_checkpoint", default="ckpts/first_stage.pt")
    p.add_argument("--stage2_config", default="configs/inference-v02.yaml")
    p.add_argument("--stage2_checkpoint", default="ckpts/second_stage.pt")
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--clip_size", type=int, default=16)
    p.add_argument("--resolution", type=int, nargs=2, default=[512, 512])
    p.add_argument("--stage2_resolution", type=int, nargs=2, default=[1024, 1024])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--vae_bf16", action="store_true", help="cast the VAEs to bf16 too")
    p.add_argument("--parallel", default="auto", choices=list(MODES),
                   help="how a batch splits over the group's ranks: whole assets (throughput, "
                        "batch %% ranks == 0), blocks of frames (latency), or auto: throughput "
                        "where the batch divides, else latency")
    add_turbo_arguments(p)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    turbo = dict(encoder_reuse=args.encoder_reuse, cfg_interval=args.cfg_interval)

    paths = sorted(q for pat in ("*.png", "*.jpg", "*.jpeg", "*.webp")
                   for q in glob.glob(os.path.join(args.image_dir, pat)))
    if not paths:
        raise SystemExit(f"no images found under {args.image_dir!r}")
    n_real = len(paths)
    bsz = args.batch or n_real
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if (bsz * args.clip_size) % world:
        raise SystemExit(
            f"--batch {bsz} × --clip_size {args.clip_size} must divide the {world} ranks; pick "
            f"a batch size with (batch·frames) % ranks == 0")
    device, own_group = dist.init(args.device)
    try:
        return _serve(args, paths, bsz, device, turbo)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _serve(args, paths, bsz, device, turbo) -> Dict:
    rank, world = dist.rank(), dist.world()
    images = load_images(paths, args.resolution)
    names = _unique_names(paths)
    n_real = len(images)
    if n_real % bsz:
        pad = bsz - n_real % bsz
        images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)])
    batches = [images[i:i + bsz] for i in range(0, len(images), bsz)]
    tag = f"[serve rank {rank}/{world}]" if world > 1 else "[serve]"
    print(f"{tag} {n_real} assets in {len(batches)} batches of {bsz}, mode={args.mode}, "
          f"clip_size={args.clip_size}, device={device}")

    from .common import load_inference_model

    def load(config, ckpt):
        return load_inference_model(config, ckpt, device, vae_bf16=args.vae_bf16, tag="serve",
                                    seed=args.seed, clip_size=args.clip_size)

    t0 = time.perf_counter()
    outputs = []

    def export(videos: Optional[np.ndarray], offset: int) -> None:
        if videos is None:  # another rank writes
            return
        for j, vid in enumerate(videos):
            if offset + j >= n_real:
                return  # padding
            out = export_to_video(tensor2vid(vid), os.path.join(
                args.output_dir, names[offset + j], "orbit.mp4"), fps=args.fps)
            outputs.append(out)
            print(f"{tag} wrote {out}")

    if args.mode == "orbit":
        model = load(args.stage1_config, args.stage1_checkpoint)
        print(f"{tag} model ready in {time.perf_counter() - t0:.1f}s")
        timer = PhaseTimer(device)
        t0 = time.perf_counter()
        server = OrbitServer(model, mode=args.parallel)
        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed)
        for i, chunk in enumerate(batches):
            export(server.generate(chunk, elevations=[args.elevation] * len(chunk),
                                   generator=generator, output_dtype="uint8", timer=timer,
                                   **turbo), i * bsz)
            timer.mark("io")
        phases = dict(timer.rows)
    else:
        ranks = stage_ranks(world)
        # every rank builds both sub-groups (TwoStageServer); a rank loads
        # only its own stage's engine past world 1
        model = model2 = None
        if rank in ranks[0]:
            model = load(args.stage1_config, args.stage1_checkpoint)
        if rank in ranks[1]:
            model2 = load(args.stage2_config, args.stage2_checkpoint)
        print(f"{tag} model{'s' if model is not None and model2 is not None else ''} ready in "
              f"{time.perf_counter() - t0:.1f}s")
        server = TwoStageServer(model, model2, mode=args.parallel)
        timer, timer2 = PhaseTimer(device), PhaseTimer(device)
        t0 = time.perf_counter()
        stream = server.generate_stream(
            batches, elevations=args.elevation, seed=args.seed,
            stage2_hw=tuple(args.stage2_resolution), output_dtype="uint8",
            timers=(timer if model is not None else None, timer2 if model2 is not None else None),
            **turbo)
        for i, videos in enumerate(stream):
            export(videos, i * bsz)
            timer2.mark("io")
        phases = {**{f"stage1_{k}": v for k, v in timer.rows.items()},
                  **{f"stage2_{k}": v for k, v in timer2.rows.items()}}
    dt = time.perf_counter() - t0
    print(f"{tag} phases " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    print(f"{tag} {n_real} assets in {dt:.1f}s ({dt / n_real:.1f}s/asset)")
    return {"outputs": outputs, "phases": phases, "batches": len(batches), "rank": rank}


if __name__ == "__main__":
    main()
