"""Batched orbit serving on one GPU (counterpart of hi3d_tpu/pipelines/serve.py).

    python -m hi3d_tpu_torch.pipelines.serve --image_dir <images> --output_dir <out> \\
        --batch 2 --clip_size 48

`OrbitServer` turns B object images into B orbit videos with one conditioner
pass over the B assets, one sampler run over the (B·T) frames (the UNet sees
B videos, CFG-doubled) and a chunked VAE decode: the JAX server's throughput
mode on a one-device mesh. There is no mesh and no replicated-parameter copy
on one GPU. `main` is the CLI in orbit mode: a directory of images → per
asset `<name>/frames/NNN.png`, and `<name>/orbit.mp4` when a video writer
imports. `--mode two_stage` (RefineServer, TwoStageServer) is not ported yet.
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

from ..utils.image import load_image_rgb, resize_center_crop
from ..utils.video import denorm_to_uint8, export_to_video, tensor2vid
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
                               num_video_frames=t, generator=generator, randn=randn)
        timer.mark("sampler")
        decoded = model.decode_first_stage(samples)
        if not bool(torch.isfinite(decoded).all()):
            raise FloatingPointError("VAE decode produced non-finite values")
        timer.mark("vae_decode")
        out = denorm_to_uint8(decoded) if output_dtype == "uint8" else decoded.clamp(-1.0, 1.0)
        out = out.cpu().numpy().reshape(b, t, h, w, 3)
        timer.mark("to_host")
        return out


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
    """Batch-serving CLI: a directory of images → one orbit per image.
    Returns {"outputs": paths written, "phases": seconds per phase,
    "batches": UNet batches run}."""
    p = argparse.ArgumentParser(description="Hi3D batched orbit serving on one GPU (PyTorch port)")
    p.add_argument("--image_dir", required=True,
                   help="directory of input images (png; jpg/jpeg/webp need cv2)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mode", default="orbit", choices=["orbit", "two_stage"])
    p.add_argument("--batch", type=int, default=0,
                   help="assets per batch (default: one batch of all images); a smaller final "
                        "batch is padded with its last image, and the padded outputs are dropped")
    p.add_argument("--stage1_config", default="configs/inference-v01.yaml")
    p.add_argument("--stage1_checkpoint", default="ckpts/first_stage.pt")
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--clip_size", type=int, default=16)
    p.add_argument("--resolution", type=int, nargs=2, default=[512, 512])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--vae_bf16", action="store_true", help="cast the VAEs to bf16 too")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mode == "two_stage":
        raise NotImplementedError(
            "--mode two_stage (RefineServer and TwoStageServer) is not ported yet; it comes in a "
            "later PR. Run --mode orbit, then pipelines.v2v on each asset's frames.")

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

    t0 = time.perf_counter()
    model = load_inference_model(args.stage1_config, args.stage1_checkpoint, args.device,
                                 vae_bf16=args.vae_bf16, tag="serve", seed=args.seed,
                                 clip_size=args.clip_size)
    print(f"[serve] model ready in {time.perf_counter() - t0:.1f}s")
    server = OrbitServer(model)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(args.seed)
    timer = PhaseTimer(model.device)
    t0 = time.perf_counter()
    outputs = []
    for i, chunk in enumerate(batches):
        videos = server.generate(chunk, elevations=[args.elevation] * len(chunk),
                                 generator=generator, output_dtype="uint8", timer=timer)
        for j, vid in enumerate(videos):
            if i * bsz + j >= n_real:
                break  # padding
            out = export_to_video(tensor2vid(vid), os.path.join(
                args.output_dir, names[i * bsz + j], "orbit.mp4"), fps=args.fps)
            outputs.append(out)
            print(f"[serve] wrote {out}")
        timer.mark("io")
    dt = time.perf_counter() - t0
    print("[serve] phases " + json.dumps({k: round(v, 3) for k, v in timer.rows.items()}))
    print(f"[serve] {n_real} assets in {dt:.1f}s ({dt / n_real:.1f}s/asset)")
    return {"outputs": outputs, "phases": dict(timer.rows), "batches": len(batches)}


if __name__ == "__main__":
    main()
