"""Stage-1 inference: one image → a 16-frame orbit video (counterpart of
hi3d_tpu/pipelines/i2v.py).

    python -m hi3d_tpu_torch.pipelines.i2v --image_path demo/3.png --skip_rembg

Background removal (U²-Net on the model's device, `utils.image.remove_background`;
`<output_dir>/temp_image/{rgba,white}.png`) unless --skip_rembg → preprocess
(resize + center crop, T copies) → add_custom_cond → conditioner
(c, uc) with the frame keys zeroed in uc → 25 Euler-EDM steps with per-frame
linear CFG (bf16 UNet, fp32 σ-math) → fp32 VAE decode in chunks → uint8
frames → `<output_dir>/first_step/frames/NNN.png` (+ first.mp4 when a video
writer imports).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.image import load_image_rgb, remove_background, resize_center_crop
from ..utils.video import denorm_to_uint8, export_to_video, range_from_uint8, tensor2vid

UC_ZERO_KEYS = ("cond_frames", "cond_frames_without_noise")


class PhaseTimer:
    """Wall time per phase; synchronises the device at each mark so a phase
    owns its device work."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rows: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.rows[name] = self.rows.get(name, 0.0) + now - self._t
        self._t = now


def prepare_frames(image_path: str, clip_size: int, resolution: Tuple[int, int]) -> np.ndarray:
    """(T, H, W, 3) uint8: T copies of the preprocessed image."""
    img = resize_center_crop(load_image_rgb(image_path), resolution)
    return np.repeat(img[None], clip_size, axis=0)


@torch.no_grad()
def generate_orbit(
    model,
    frames: np.ndarray,
    elevation: float = 0.0,
    generator: Optional[torch.Generator] = None,
    num_steps: Optional[int] = None,
    randn=None,  # (T, h/8, w/8, 4) unit noise
    batch_overrides: Optional[Dict] = None,  # applied after add_custom_cond
    output_dtype: str = "float32",
    timer: Optional[PhaseTimer] = None,
) -> np.ndarray:
    """frames (T, H, W, 3) uint8 or [-1, 1] float → orbit (T, H, W, 3),
    float32 in [-1, 1] or uint8 (`output_dtype`). frames[0] conditions."""
    t = model.num_samples
    if frames.shape[0] != t:
        raise ValueError(f"frames carry {frames.shape[0]} frames, model expects {t}")
    h, w = frames.shape[1:3]
    device = model.device
    timer = timer or PhaseTimer(device)
    x = torch.as_tensor(np.asarray(frames)).to(device)
    video = range_from_uint8(x) if x.dtype == torch.uint8 else x.to(torch.float32)
    batch: Dict = {
        "video": video.permute(0, 3, 1, 2)[None],
        "elevation": torch.tensor([elevation], dtype=torch.float32, device=device),
    }
    batch = model.add_custom_cond(batch, infer=True, generator=generator)
    if batch_overrides:
        batch.update(batch_overrides)
    c, uc = model.conditioner.get_unconditional_conditioning(
        batch, force_uc_zero_embeddings=list(UC_ZERO_KEYS)
    )
    timer.mark("conditioner")
    samples = model.sample(cond=c, uc=uc, shape=(t, h // 8, w // 8, 4), num_video_frames=t,
                           generator=generator, randn=randn, num_steps=num_steps)
    timer.mark("sampler")
    decoded = model.decode_first_stage(samples)
    if not bool(torch.isfinite(decoded).all()):
        raise FloatingPointError("VAE decode produced non-finite values")
    timer.mark("vae_decode")
    if output_dtype == "uint8":
        out = denorm_to_uint8(decoded).cpu().numpy()
    else:
        out = decoded.clamp(-1.0, 1.0).cpu().numpy()
    timer.mark("to_host")
    return out


def run_pipeline(model, image_path: str, output_dir: str, elevation: float = 0.0,
                 clip_size: int = 16, resolution: Sequence[int] = (512, 512),
                 num_iter: int = 1, seed: Optional[int] = None, fps: int = 8,
                 skip_rembg: bool = False, num_steps: Optional[int] = None) -> str:
    """Full stage-1 CLI behaviour; returns the mp4 path (or the frames
    directory when no video writer imports)."""
    device = model.device
    timer = PhaseTimer(device)
    temp_dir = os.path.join(output_dir, "temp_image")
    os.makedirs(temp_dir, exist_ok=True)
    if not skip_rembg:
        image_path = remove_background(image_path, os.path.join(temp_dir, "rgba.png"),
                                       os.path.join(temp_dir, "white.png"), device=device)
        timer.mark("rembg")
    generator = torch.Generator(device=device)
    generator.manual_seed(0 if seed is None else seed)
    model.num_samples = clip_size
    frames = prepare_frames(image_path, clip_size, tuple(resolution))
    timer.mark("io")
    out_frames: List[np.ndarray] = []
    for _ in range(num_iter):
        video = generate_orbit(model, frames, elevation=elevation, generator=generator,
                               num_steps=num_steps, output_dtype="uint8", timer=timer)
        new = tensor2vid(video)
        # consecutive orbits share the boundary frame (reference :108-112)
        out_frames.extend(new if not out_frames else new[1:])
        frames = frames.copy()
        frames[0] = out_frames[-1]
    out = export_to_video(out_frames, os.path.join(output_dir, "first_step", "first.mp4"), fps=fps)
    timer.mark("io")
    print("[i2v] phases " + json.dumps({k: round(v, 3) for k, v in timer.rows.items()}))
    return out


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Hi3D stage 1 (PyTorch port): image → orbit video")
    p.add_argument("--denoise_config", default="configs/inference-v01.yaml")
    p.add_argument("--denoise_checkpoint", default="ckpts/first_stage.pt")
    p.add_argument("--image_path", required=True)
    p.add_argument("--output_dir", default="outputs/i2v")
    p.add_argument("--elevation", type=float, default=0)
    p.add_argument("--clip_size", type=int, default=16)
    p.add_argument("--resolution", type=int, nargs=2, default=[512, 512])
    p.add_argument("--num_iter", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler chrome trace of the run here")
    p.add_argument("--vae_bf16", action="store_true", help="cast the VAEs to bf16 too")
    p.add_argument("--skip_rembg", action="store_true")
    p.add_argument("--num_steps", type=int, default=None,
                   help="override the config's sampler step count")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .common import load_inference_model

    t0 = time.perf_counter()
    model = load_inference_model(args.denoise_config, args.denoise_checkpoint, args.device,
                                 vae_bf16=args.vae_bf16, tag="i2v",
                                 seed=0 if args.seed is None else args.seed)
    print(f"[i2v] model ready in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kw = dict(elevation=args.elevation, clip_size=args.clip_size, resolution=args.resolution,
              num_iter=args.num_iter, seed=args.seed, skip_rembg=args.skip_rembg,
              num_steps=args.num_steps)
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if model.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            out = run_pipeline(model, args.image_path, args.output_dir, **kw)
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "i2v_trace.json"))
    else:
        out = run_pipeline(model, args.image_path, args.output_dir, **kw)
    print(f"[i2v] wrote {out} in {time.perf_counter() - t0:.1f}s")
    return out


if __name__ == "__main__":
    main()
