"""Stage-2 inference: stage-1 frames + the clean image → a 16×1024² refined
video (counterpart of hi3d_tpu/pipelines/v2v.py).

    python -m hi3d_tpu_torch.pipelines.v2v --image_path demo/3.png --output_dir outputs/i2v

1. read the stage-1 video (`<output_dir>/first_step/first.mp4`, the H.264
   mp4 the port's i2v writes, as JAX's default; or a frames directory), keep the last
   `clip_size`, replace frame 0 with the clean image, resize to 1024²;
2. add_custom_cond (cond_frames = the noise-augmented video) → conditioner
   (c, uc) with the frame keys zeroed in uc: CLIP ViT-H of frame 0, the DPT
   depth of every frame (9 concat channels), the VAE latent of every frame (4
   concat channels), elevation and cond_aug vectors;
3. fp32 VAE encode of the video one frame at a time → z;
4. the latent-blending loop: at step i, α = (0.5·(1 + cos(i/num_steps)))^40,
   lat ← lat·(1 − α) + (init_noise·σ_i + z)·α, then one Euler step with
   per-frame linear CFG (bf16 UNet, fp32 σ-math), through the sampler's
   `step_call` (so a Heun config's correction reaches the loop);
5. fp32 VAE decode one frame at a time → uint8 frames →
   `<output_dir>/second_step_video/frames/NNN.png` and `second.mp4`.

`--encoder_reuse k` refreshes the UNet's encoder cache on the steps where
`reuse_flags` is False and decodes from it elsewhere; `--cfg_interval LO HI`
runs CFG only on steps whose float32 σ lies in [LO, HI]. Both are opt-in
approximations, off by default, and exclusive.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..conditioners import DepthEmbedder
from ..diffusion.encoder_reuse import reuse_flags, step_denoiser
from ..diffusion.samplers import _flag_segments, cfg_flags
from ..utils.image import foreground_mask_from_white, load_image_rgb, resize_bilinear_u8
from ..utils.video import (
    denorm_to_uint8,
    export_to_video,
    import_video,
    range_from_uint8,
    tensor2vid,
)
from .common import add_turbo_arguments
from .i2v import UC_ZERO_KEYS, PhaseTimer

ALPHA_POW = 40.0


def blend_alpha(i: int, num_steps: int) -> float:
    """(0.5·(1 + cos(i/num_steps)))^40 in fp32, as the JAX scan computes it."""
    a = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(i) / np.float32(num_steps)))
    return float(a ** np.float32(ALPHA_POW))


def blend_refine(model, frames: np.ndarray, masks: Optional[np.ndarray] = None,
                 elevation: float = 0.0, **kwargs) -> np.ndarray:
    """frames (T, H, W, 3) uint8 or [-1, 1] float → refined (T, H, W, 3);
    keyword arguments as `blend_refine_batch`."""
    t = model.num_samples
    if frames.shape[0] != t:
        raise ValueError(f"frames carry {frames.shape[0]} frames, model expects {t}")
    return blend_refine_batch(model, np.asarray(frames)[None],
                              masks=None if masks is None else np.asarray(masks)[None],
                              elevations=[elevation], **kwargs)[0]


@torch.no_grad()
def blend_refine_batch(
    model,
    videos,  # (B, T, H, W, 3) uint8 or [-1, 1] float, numpy or a tensor
    masks: Optional[np.ndarray] = None,  # (B, T, H, W); inference never reads them
    elevations: Optional[Sequence[float]] = None,
    generator: Optional[torch.Generator] = None,
    init_noise=None,  # (B·T, H/8, W/8, 4) unit noise, channels-last
    batch_overrides: Optional[Dict] = None,  # applied after add_custom_cond
    num_steps: Optional[int] = None,
    encoder_reuse: int = 0,  # turbo: the UNet encoder every k-th step (approximate)
    cfg_interval=None,  # (lo, hi): CFG only where σ ∈ [lo, hi] (turbo)
    output_dtype: str = "float32",
    timer: Optional[PhaseTimer] = None,
    frames=None,
):
    """Stage-2 latent-blending refinement of B videos → (B, T, H, W, 3),
    float32 in [-1, 1] or uint8 (`output_dtype`), a numpy array.

    With `frames` (a `parallel.dist.FrameShard`, serving across ranks) this
    process refines the rows of the B·T frames it holds and returns them,
    decoded, (rows, H, W, 3) fp32 on the model's device, for the caller to
    check and convert across the ranks: the conditioner runs
    on every video, its per-frame outputs cut to the rows; the VAE encode,
    the α-blend and the decode take the rows alone; every draw is the whole
    batch's, cut to the rows; the UNet runs frame-parallel when the shard
    has a group (latency mode).

    Phases go to `timer`: conditioner (without the DPT), dpt (the
    DepthEmbedder), vae_encode, sampler, vae_decode, to_host."""
    b, t = videos.shape[:2]
    if t != model.num_samples:
        raise ValueError(f"videos carry {t} frames, model expects {model.num_samples}")
    device = model.device
    timer = timer or PhaseTimer(device)
    sampler = model.sampler
    num_steps = int(num_steps) if num_steps else sampler.num_steps
    sig = sampler.schedule(num_steps)  # float32 on the host, σ = 0 appended
    cfg_on = cfg_flags(sig, cfg_interval, encoder_reuse)
    sigmas = torch.as_tensor(sig, device=device)

    x = (videos if isinstance(videos, torch.Tensor) else torch.as_tensor(np.asarray(videos))).to(device)
    video = range_from_uint8(x) if x.dtype == torch.uint8 else x.to(torch.float32)
    video = video.permute(0, 1, 4, 2, 3)  # (B, T, 3, H, W)
    batch: Dict = {"video": video,
                   "elevation": torch.tensor(list(elevations) if elevations is not None
                                             else [0.0] * b, dtype=torch.float32, device=device)}
    if masks is not None:
        batch["masks"] = np.asarray(masks)
    batch = model.add_custom_cond(batch, infer=True, generator=generator)
    if batch_overrides:
        batch.update(batch_overrides)

    # the DepthEmbedder's own time is its phase: marks around its forward
    hooks = []
    for emb in model.conditioner.embedders:
        if isinstance(emb, DepthEmbedder):
            hooks.append(emb.register_forward_pre_hook(lambda *_: timer.mark("conditioner")))
            hooks.append(emb.register_forward_hook(lambda *_: timer.mark("dpt")))
    try:
        c, uc = model.conditioner.get_unconditional_conditioning(
            batch, force_uc_zero_embeddings=list(UC_ZERO_KEYS))
    finally:
        for h in hooks:
            h.remove()
    timer.mark("conditioner")

    rows = video.reshape(b * t, *video.shape[2:]).permute(0, 2, 3, 1)
    if frames is not None:
        rows = frames.take(rows)
        c, uc = frames.take_cond(c), frames.take_cond(uc)
    z = model.encode_first_stage(rows).float().permute(0, 3, 1, 2)  # (B·T, 4, h, w)
    timer.mark("vae_encode")

    full = (b * t,) + tuple(z.shape[1:])
    if init_noise is None:
        noise = (torch.randn(full, generator=generator, device=device) if frames is None
                 else frames.randn(full, generator, device))
    else:
        noise = torch.as_tensor(np.asarray(init_noise), dtype=torch.float32,
                                device=device).permute(0, 3, 1, 2)
        noise = noise if frames is None else frames.take(noise)
    lat = noise * torch.sqrt(1.0 + sigmas[0] ** 2.0)
    dtype = model.compute_dtype
    parallel = frames is not None and frames.group is not None
    videos = z.shape[0] // t if frames is not None and not parallel else b
    denoiser = model.make_denoiser_fn(t, torch.zeros((2 * videos, t), device=device),
                                      cached=bool(encoder_reuse),
                                      frame_shard=frames if parallel else None)
    reuse = reuse_flags(num_steps, encoder_reuse) if encoder_reuse else None
    cache = None
    with sampler.use_frames(frames):
        for s0, s1, use_cfg in _flag_segments(cfg_on):
            for i in range(s0, s1):
                alpha = blend_alpha(i, num_steps)
                lat = lat * (1.0 - alpha) + (noise * sigmas[i] + z) * alpha
                den = denoiser
                if reuse is not None:
                    den, cell = step_denoiser(denoiser, cache if reuse[i] else None)
                lat = sampler.step_call(den, lat.to(dtype), i, sig, c, uc,
                                        use_cfg=use_cfg).float()
                if reuse is not None:
                    cache = cell["cache"]
    cache = cell = den = None  # free the encoder cache (every skip activation) before the decode
    timer.mark("sampler")

    decoded = model.decode_first_stage(lat.to(dtype).permute(0, 2, 3, 1))
    if frames is not None:  # the serving caller checks and converts across the ranks
        timer.mark("vae_decode")
        return decoded
    if not bool(torch.isfinite(decoded).all()):
        raise FloatingPointError("VAE decode produced non-finite values")
    timer.mark("vae_decode")
    if output_dtype == "uint8":
        out = denorm_to_uint8(decoded).cpu().numpy()
    else:
        out = decoded.clamp(-1.0, 1.0).cpu().numpy()
    timer.mark("to_host")
    return out.reshape(b, t, *out.shape[1:])


def prepare_inputs(image_path: str, video_path: str, clip_size: int,
                   resolution: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(frames (T, H, W, 3) uint8, masks (T, H, W)): the last `clip_size`
    frames of the stage-1 video with frame 0 replaced by the clean image,
    each resized to `resolution` (cv2-free bilinear); masks mark the
    non-white foreground."""
    raw = import_video(video_path)
    if raw.shape[0] < clip_size:
        raise ValueError(f"{video_path!r} holds {raw.shape[0]} frames, clip_size is {clip_size}")
    frames = list(raw[-clip_size:])
    frames[0] = load_image_rgb(image_path)
    frames = [resize_bilinear_u8(f, (resolution[1], resolution[0])) for f in frames]
    return np.stack(frames), np.stack([foreground_mask_from_white(f) for f in frames])


def run_pipeline(model, image_path: str, video_path: str, output_dir: str,
                 elevation: float = 0.0, clip_size: int = 16,
                 resolution: Sequence[int] = (1024, 1024), num_iter: int = 1,
                 seed: Optional[int] = None, fps: int = 8,
                 num_steps: Optional[int] = None, encoder_reuse: int = 0,
                 cfg_interval=None) -> str:
    """Full stage-2 CLI behaviour; returns the mp4 path."""
    device = model.device
    timer = PhaseTimer(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(0 if seed is None else seed)
    model.num_samples = clip_size
    frames, masks = prepare_inputs(image_path, video_path, clip_size, tuple(resolution))
    timer.mark("io")
    out_frames: List[np.ndarray] = []
    for _ in range(num_iter):
        video = blend_refine(model, frames, masks, elevation=elevation, generator=generator,
                             num_steps=num_steps, encoder_reuse=encoder_reuse,
                             cfg_interval=cfg_interval, output_dtype="uint8", timer=timer)
        new = tensor2vid(video)
        out_frames.extend(new if not out_frames else new[1:])
        frames = frames.copy()
        frames[0] = out_frames[-1]
    out = export_to_video(out_frames, os.path.join(output_dir, "second_step_video", "second.mp4"),
                          fps=fps)
    timer.mark("io")
    print("[v2v] phases " + json.dumps({k: round(v, 3) for k, v in timer.rows.items()}))
    return out


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Hi3D stage 2 (PyTorch port): video refinement")
    p.add_argument("--denoise_config", default="configs/inference-v02.yaml")
    p.add_argument("--denoise_checkpoint", default="ckpts/second_stage.pt")
    p.add_argument("--image_path", required=True, help="clean (white-background) image")
    p.add_argument("--video_path", default=None,
                   help="stage-1 video: an mp4 or a frames directory; "
                        "default <output_dir>/first_step/first.mp4")
    p.add_argument("--output_dir", default="outputs/i2v")
    p.add_argument("--elevation", type=float, default=0)
    p.add_argument("--clip_size", type=int, default=16)
    p.add_argument("--resolution", type=int, nargs=2, default=[1024, 1024])
    p.add_argument("--num_iter", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler chrome trace of the run here")
    p.add_argument("--vae_bf16", action="store_true", help="cast the VAEs to bf16 too")
    p.add_argument("--num_steps", type=int, default=None,
                   help="override the config's sampler step count")
    add_turbo_arguments(p)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .common import load_inference_model

    video_path = args.video_path or os.path.join(args.output_dir, "first_step", "first.mp4")
    t0 = time.perf_counter()
    model = load_inference_model(args.denoise_config, args.denoise_checkpoint, args.device,
                                 vae_bf16=args.vae_bf16, tag="v2v",
                                 seed=0 if args.seed is None else args.seed)
    print(f"[v2v] model ready in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kw = dict(elevation=args.elevation, clip_size=args.clip_size, resolution=args.resolution,
              num_iter=args.num_iter, seed=args.seed, num_steps=args.num_steps,
              encoder_reuse=args.encoder_reuse, cfg_interval=args.cfg_interval)
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if model.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            out = run_pipeline(model, args.image_path, video_path, args.output_dir, **kw)
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "v2v_trace.json"))
    else:
        out = run_pipeline(model, args.image_path, video_path, args.output_dir, **kw)
    print(f"[v2v] wrote {out} in {time.perf_counter() - t0:.1f}s")
    return out


if __name__ == "__main__":
    main()
