"""Both stages chained: one image → stage-1 orbit (16×512²) → stage-2 refined
views (16×1024²) → per-view CLIP / aesthetic scores (counterpart of
hi3d_tpu/pipelines/full.py).

    python -m hi3d_tpu_torch.pipelines.full --image_path demo/3.png --output_dir outputs/3

Stage 1 (`i2v.run_pipeline`, background removal included unless
--skip_rembg) writes `<output_dir>/first_step/`; stage 2 (`v2v.run_pipeline`)
reads those frames and `temp_image/white.png` (the input image when
background removal was skipped or found no model) and writes
`<output_dir>/second_step_video/`; `ViewScorer` scores the first
`clip_size` refined views against the white image; `metrics.json` holds the
paths, the stage seconds and the scores. A stage given as a factory is
built when its turn comes and released after it, so the two engines are
never resident together.

`--encoder_reuse` and `--cfg_interval` (opt-in approximations of the JAX
CLI) are not ported.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..models.clip import AestheticMLP, clip_normalize, resize_bilinear, vit_l_14
from ..utils.image import load_image_rgb
from ..utils.video import import_video
from . import i2v, v2v


class ViewScorer:
    """CLIP ViT-L/14 cosine similarity to the input image and LAION aesthetic
    score, per view, in fp32 on `device`.

    The towers are injectable (tests); by default they load from the
    AesEmbedder's weight files (`clip_path`, a TorchScript archive, and
    `mlp_path`) when present, else they are random-initialised from seed 0
    (the scores then measure only relative drift)."""

    def __init__(self, clip: Optional[nn.Module] = None, mlp: Optional[nn.Module] = None,
                 clip_path: str = "ckpts/ViT-L-14.pt",
                 mlp_path: str = "ckpts/metric_models/sac+logos+ava1-l14-linearMSE.pth",
                 device="cuda"):
        from ..conditioners import _load_visual, _tower_file_notice

        device = torch.device(device)
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(0)
            if clip is None:
                clip = vit_l_14()
                if os.path.exists(clip_path):
                    _load_visual(clip, torch.jit.load(clip_path, map_location="cpu").state_dict())
                else:
                    _tower_file_notice("CLIP ViT-L/14", clip_path)
            if mlp is None:
                mlp = AestheticMLP(getattr(clip, "output_dim", 768))
                if os.path.exists(mlp_path):
                    mlp.load_state_dict(torch.load(mlp_path, map_location="cpu", weights_only=True))
                else:
                    _tower_file_notice("aesthetic MLP", mlp_path)
        self.clip = clip.to(device, torch.float32).eval()
        self.mlp = mlp.to(device, torch.float32).eval()
        self.device = device
        self._res = getattr(clip, "image_size", 224)

    def _features(self, frames_uint8: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 → L2-normalised CLIP features (N, D), fp32."""
        x = torch.as_tensor(frames_uint8, device=self.device).permute(0, 3, 1, 2).float() / 255.0
        x = clip_normalize(resize_bilinear(x, (self._res, self._res)))
        feats = self.clip(x).float()
        return feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    @torch.no_grad()
    def __call__(self, ref_image_uint8: np.ndarray, views_uint8: Sequence[np.ndarray]) -> Dict:
        fv = self._features(np.stack(views_uint8))
        fr = self._features(np.asarray(ref_image_uint8)[None])
        sims = (fv @ fr[0]).cpu().numpy()
        aes = self.mlp(fv)[:, 0].float().cpu().numpy()
        return {
            "clip_similarity": [round(float(s), 4) for s in sims],
            "clip_similarity_mean": round(float(sims.mean()), 4),
            "aesthetic": [round(float(a), 4) for a in aes],
            "aesthetic_mean": round(float(aes.mean()), 4),
        }


def _release() -> None:
    """Return a released engine's device memory: the engine sits in
    reference cycles, so collect before emptying the allocator's cache."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _allocated_gb() -> Optional[float]:
    return torch.cuda.memory_allocated() / 1e9 if torch.cuda.is_available() else None


def run_two_stage(
    stage1_model,
    stage2_model,
    image_path: str,
    output_dir: str,
    elevation: float = 0.0,
    clip_size: int = 16,
    stage1_resolution: Sequence[int] = (512, 512),
    stage2_resolution: Sequence[int] = (1024, 1024),
    seed: Optional[int] = None,
    fps: int = 8,
    skip_rembg: bool = False,
    scorer: Optional[ViewScorer] = None,
    score_views: bool = True,
    num_steps: Optional[int] = None,  # sampler step override, both stages
) -> Dict:
    """Stage 1 → stage 2 → scoring; returns the paths, the stage seconds and
    the metrics, also written to `<output_dir>/metrics.json`.

    Either stage is a built engine (an `nn.Module`) or a zero-argument
    factory; a stage built here is released (`del`, `gc.collect()`,
    `torch.cuda.empty_cache()`) before the next one is built. On a CUDA host
    the result also carries `allocated_gb`: the allocator's bytes before
    stage 1 and after its release."""
    t0 = time.perf_counter()
    before = _allocated_gb()
    owns1 = not isinstance(stage1_model, nn.Module)
    m1 = stage1_model() if owns1 else stage1_model
    first_mp4 = i2v.run_pipeline(m1, image_path, output_dir, elevation=elevation,
                                 clip_size=clip_size, resolution=stage1_resolution, seed=seed,
                                 fps=fps, skip_rembg=skip_rembg, num_steps=num_steps)
    del m1
    if owns1:
        _release()
    after = _allocated_gb()
    t1 = time.perf_counter()
    white = os.path.join(output_dir, "temp_image", "white.png")
    if not os.path.exists(white):
        white = image_path  # background removal skipped or unavailable
    owns2 = not isinstance(stage2_model, nn.Module)
    m2 = stage2_model() if owns2 else stage2_model
    device = m2.device
    second_mp4 = v2v.run_pipeline(m2, white, first_mp4, output_dir, elevation=elevation,
                                  clip_size=clip_size, resolution=stage2_resolution, seed=seed,
                                  fps=fps, num_steps=num_steps)
    del m2
    if owns2:
        _release()
    t2 = time.perf_counter()

    result: Dict = {
        "first_mp4": first_mp4,
        "second_mp4": second_mp4,
        "stage1_sec": round(t1 - t0, 2),
        "stage2_sec": round(t2 - t1, 2),
        "total_sec": round(t2 - t0, 2),
    }
    if before is not None:
        result["allocated_gb"] = {"before_stage1": round(before, 4),
                                  "after_stage1_released": round(after, 4)}
    if score_views:
        scorer = scorer if scorer is not None else ViewScorer(device=device)
        views = import_video(second_mp4, max_frames=clip_size)
        result["metrics"] = scorer(load_image_rgb(white), list(views))
    with open(os.path.join(output_dir, "metrics.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(
        description="Hi3D both stages (PyTorch port): image → 16×1024² multi-view set")
    p.add_argument("--stage1_config", default="configs/inference-v01.yaml")
    p.add_argument("--stage1_checkpoint", default="ckpts/first_stage.pt")
    p.add_argument("--stage2_config", default="configs/inference-v02.yaml")
    p.add_argument("--stage2_checkpoint", default="ckpts/second_stage.pt")
    p.add_argument("--image_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--clip_size", type=int, default=16)
    p.add_argument("--stage1_resolution", type=int, nargs=2, default=[512, 512])
    p.add_argument("--stage2_resolution", type=int, nargs=2, default=[1024, 1024])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler chrome trace of the run here")
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--skip_rembg", action="store_true")
    p.add_argument("--no_metrics", action="store_true")
    p.add_argument("--vae_bf16", action="store_true", help="cast the VAEs to bf16 too")
    p.add_argument("--num_steps", type=int, default=None,
                   help="override both stages' sampler step count (configs: 25)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"[full] --device {device} requested but CUDA is not available")

    from .common import load_inference_model

    def _load(config_path, ckpt_path):
        return lambda: load_inference_model(
            config_path, ckpt_path, device, vae_bf16=args.vae_bf16, tag="full",
            seed=0 if args.seed is None else args.seed, clip_size=args.clip_size)

    def run():
        return run_two_stage(
            _load(args.stage1_config, args.stage1_checkpoint),
            _load(args.stage2_config, args.stage2_checkpoint),
            args.image_path, args.output_dir, elevation=args.elevation,
            clip_size=args.clip_size, stage1_resolution=args.stage1_resolution,
            stage2_resolution=args.stage2_resolution, seed=args.seed, fps=args.fps,
            skip_rembg=args.skip_rembg, score_views=not args.no_metrics,
            num_steps=args.num_steps)

    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            result = run()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "full_trace.json"))
    else:
        result = run()
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
