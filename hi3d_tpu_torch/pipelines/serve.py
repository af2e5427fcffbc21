"""Batched serving on one GPU (counterpart of hi3d_tpu/pipelines/serve.py).

    python -m hi3d_tpu_torch.pipelines.serve --image_dir <images> --output_dir <out> \\
        --batch 2 --clip_size 48
    python -m hi3d_tpu_torch.pipelines.serve --image_dir <images> --output_dir <out> \\
        --mode two_stage --batch 1

`OrbitServer` turns B object images into B orbit videos with one conditioner
pass over the B assets, one sampler run over the (B·T) frames (the UNet sees
B videos, CFG-doubled) and a chunked VAE decode: the JAX server's throughput
mode on a one-device mesh. There is no mesh and no replicated-parameter copy
on one GPU. `RefineServer` runs stage 2's latent-blending refinement
(`v2v.blend_refine_batch`) on B videos; `TwoStageServer` keeps both engines
resident on the one card and, in `generate_stream`, runs stage 1 of batch
N+1 in a producer thread while stage 2 refines batch N. `main` is the CLI:
a directory of images → per asset `<name>/frames/NNN.png`, and
`<name>/orbit.mp4` when a video writer imports; `--mode orbit` writes stage
1's orbits, `--mode two_stage` stage 2's refined views at
`--stage2_resolution`.
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

from ..utils.image import load_image_rgb, resize_center_crop
from ..utils.video import denorm_to_uint8, export_to_video, tensor2vid
from .common import add_turbo_arguments
from .i2v import UC_ZERO_KEYS, PhaseTimer


class OrbitServer:
    """Stage-1 multi-asset orbit generation on the model's device."""

    def __init__(self, model):
        self.model = model

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
    ) -> np.ndarray:
        """→ (B, T, H, W, 3), float32 in [-1, 1] or uint8 (`output_dtype`)."""
        model = self.model
        b, h, w, _ = images.shape
        t = model.num_samples
        timer = timer or PhaseTimer(model.device)
        c, uc = self.condition(images, elevations, generator, batch_overrides)
        timer.mark("conditioner")
        samples = model.sample(cond=c, uc=uc, shape=(b * t, h // 8, w // 8, 4),
                               num_video_frames=t, generator=generator, randn=randn,
                               encoder_reuse=encoder_reuse, cfg_interval=cfg_interval)
        timer.mark("sampler")
        decoded = model.decode_first_stage(samples)
        if not bool(torch.isfinite(decoded).all()):
            raise FloatingPointError("VAE decode produced non-finite values")
        timer.mark("vae_decode")
        out = denorm_to_uint8(decoded) if output_dtype == "uint8" else decoded.clamp(-1.0, 1.0)
        out = out.cpu().numpy().reshape(b, t, h, w, 3)
        timer.mark("to_host")
        return out


def fold_generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on `device` for stream `stream` of `seed`: the same pair
    always gives the same numbers, different pairs independent ones (JAX's
    fold_in(PRNGKey(seed), stream))."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class RefineServer:
    """Stage-2 latent-blending refinement of B videos on the model's device
    (the B·T frames in one blend loop)."""

    def __init__(self, model):
        self.model = model

    def refine(self, videos, elevations: Optional[Sequence[float]] = None,
               masks: Optional[np.ndarray] = None,
               generator: Optional[torch.Generator] = None, init_noise=None,
               batch_overrides: Optional[Dict] = None, encoder_reuse: int = 0,
               cfg_interval=None, output_dtype: str = "float32",
               timer: Optional[PhaseTimer] = None) -> np.ndarray:
        """videos (B, T, H, W, 3), uint8 or [-1, 1] float, numpy or a tensor →
        (B, T, H, W, 3), float32 in [-1, 1] or uint8 (`output_dtype`)."""
        from .v2v import blend_refine_batch

        return blend_refine_batch(self.model, videos, masks=masks, elevations=elevations,
                                  generator=generator, init_noise=init_noise,
                                  batch_overrides=batch_overrides,
                                  encoder_reuse=encoder_reuse, cfg_interval=cfg_interval,
                                  output_dtype=output_dtype, timer=timer)


class TwoStageServer:
    """Stage 1 then stage 2 with both engines resident on one card.

    `generate_stream` overlaps stage 1 of batch N+1 (a producer thread) with
    stage 2 of batch N; each batch `i` draws its noise from its own
    generators, streams 2i and 2i+1 of the seed (`stage_generators`), so the
    outputs do not depend on how the two threads interleave."""

    def __init__(self, stage1_model, stage2_model):
        self.orbit = OrbitServer(stage1_model)
        self.refine = RefineServer(stage2_model)

    def stage_generators(self, seed: int, i: int):
        """(stage-1, stage-2) generators of batch `i`."""
        return (fold_generator(self.orbit.model.device, seed, 2 * i),
                fold_generator(self.refine.model.device, seed, 2 * i + 1))

    @staticmethod
    def _to_stage2_res(videos, stage2_hw, device=None):
        """(B, T, H, W, 3) float videos → a tensor on `device` at `stage2_hw`:
        half-pixel bilinear without antialiasing (cv2.resize INTER_LINEAR
        on float frames, as the JAX server resizes)."""
        x = torch.as_tensor(np.asarray(videos), device=device)
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
        default; the turbo modes apply to both stages."""
        turbo = dict(encoder_reuse=encoder_reuse, cfg_interval=cfg_interval)
        g1, g2 = generators or self.stage_generators(0, 0)
        videos = self.orbit.generate(images, elevations=elevations, generator=g1, timer=timers[0],
                                     **turbo)
        return self._stage2(videos, elevations, g2, stage2_hw, turbo, output_dtype, timers[1])

    def generate_stream(self, batches, elevations=None, seed: int = 0,
                        stage2_hw: Optional[Sequence[int]] = None, encoder_reuse: int = 0,
                        cfg_interval=None, output_dtype: str = "float32",
                        timers=(None, None)):
        """Yield the refined videos of each batch of `batches`, in order,
        stage 1 of the next batch running in a producer thread meanwhile (a
        handoff queue of one). `elevations` is a scalar for every asset
        (batches may then differ in size) or a per-asset list applied to
        every batch (which must then all have its length). A producer's
        exception is raised here; when the consumer stops early the producer
        is stopped and joined."""
        import queue
        import threading

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
    two_stage`). Returns {"outputs": paths written, "phases": seconds per
    phase (two_stage: `stage1_*` and `stage2_*`, the two stages overlapping),
    "batches": batches run}."""
    p = argparse.ArgumentParser(description="Hi3D batched serving on one GPU (PyTorch port)")
    p.add_argument("--image_dir", required=True,
                   help="directory of input images (png; jpg/jpeg/webp need cv2)")
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
    add_turbo_arguments(p)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    turbo = dict(encoder_reuse=args.encoder_reuse, cfg_interval=args.cfg_interval)

    paths = sorted(q for pat in ("*.png", "*.jpg", "*.jpeg", "*.webp")
                   for q in glob.glob(os.path.join(args.image_dir, pat)))
    if not paths:
        raise SystemExit(f"no images found under {args.image_dir!r}")
    images = load_images(paths, args.resolution)
    names = _unique_names(paths)
    n_real = len(images)
    bsz = args.batch or n_real
    if n_real % bsz:
        pad = bsz - n_real % bsz
        images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)])
    batches = [images[i:i + bsz] for i in range(0, len(images), bsz)]
    print(f"[serve] {n_real} assets in {len(batches)} batches of {bsz}, mode={args.mode}, "
          f"clip_size={args.clip_size}, device={args.device}")

    from .common import load_inference_model

    def load(config, ckpt):
        return load_inference_model(config, ckpt, args.device, vae_bf16=args.vae_bf16,
                                    tag="serve", seed=args.seed, clip_size=args.clip_size)

    t0 = time.perf_counter()
    model = load(args.stage1_config, args.stage1_checkpoint)
    model2 = load(args.stage2_config, args.stage2_checkpoint) if args.mode == "two_stage" else None
    print(f"[serve] model{'s' if model2 is not None else ''} ready in "
          f"{time.perf_counter() - t0:.1f}s")
    timer = PhaseTimer(model.device)
    outputs = []

    def export(videos: np.ndarray, offset: int) -> None:
        for j, vid in enumerate(videos):
            if offset + j >= n_real:
                return  # padding
            out = export_to_video(tensor2vid(vid), os.path.join(
                args.output_dir, names[offset + j], "orbit.mp4"), fps=args.fps)
            outputs.append(out)
            print(f"[serve] wrote {out}")

    t0 = time.perf_counter()
    if model2 is None:
        server = OrbitServer(model)
        generator = torch.Generator(device=model.device)
        generator.manual_seed(args.seed)
        for i, chunk in enumerate(batches):
            export(server.generate(chunk, elevations=[args.elevation] * len(chunk),
                                   generator=generator, output_dtype="uint8", timer=timer,
                                   **turbo), i * bsz)
            timer.mark("io")
        phases = dict(timer.rows)
    else:
        timer2 = PhaseTimer(model2.device)
        stream = TwoStageServer(model, model2).generate_stream(
            batches, elevations=args.elevation, seed=args.seed,
            stage2_hw=tuple(args.stage2_resolution), output_dtype="uint8", timers=(timer, timer2),
            **turbo)
        for i, videos in enumerate(stream):
            export(videos, i * bsz)
            timer2.mark("io")
        phases = {**{f"stage1_{k}": v for k, v in timer.rows.items()},
                  **{f"stage2_{k}": v for k, v in timer2.rows.items()}}
    dt = time.perf_counter() - t0
    print("[serve] phases " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    print(f"[serve] {n_real} assets in {dt:.1f}s ({dt / n_real:.1f}s/asset)")
    return {"outputs": outputs, "phases": phases, "batches": len(batches)}


if __name__ == "__main__":
    main()
