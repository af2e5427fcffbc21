"""Model factory shared by the CLIs (counterpart of hi3d_tpu/pipelines/common.py)."""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Optional, Union

import torch

from ..config import instantiate_from_config, load_config


def configure_precision() -> None:
    """Full fp32 for the fp32 parts (VAE, σ-math): no TF32 in matmuls or
    cuDNN convolutions. The UNet and towers run in bf16 regardless."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def create_model(config_path: Union[str, Iterable[str]],
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
    """Build the config's model on `device` (the card unless the caller asks
    for the CPU); random init is seeded by `seed` without touching the global
    RNG state."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"create_model: device {device} requested but CUDA is not available")
    cfg = load_config(config_path)
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices), torch.device(device):
        torch.manual_seed(seed)
        model = instantiate_from_config(cfg["model"])
    return model, cfg


def load_inference_model(config_path: str, ckpt_path: Optional[str], device="cuda",
                         vae_bf16: bool = False, tag: str = "load", seed: int = 0,
                         clip_size: Optional[int] = None):
    """Build + checkpoint-load + inference-cast one engine. A missing
    checkpoint leaves the random weights, with a printed notice. `clip_size`
    sets the engine's `num_samples` (its embedders and per-frame guider
    follow)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"[{tag}] --device {device} requested but CUDA is not available")
    configure_precision()
    model, _ = create_model(config_path, device=device, seed=seed)
    if ckpt_path and os.path.exists(ckpt_path):
        model.init_from_ckpt(ckpt_path)
    else:
        print(f"[{tag}] checkpoint {ckpt_path!r} not found — random weights (smoke mode)")
    model.cast_weights_to_compute_dtype(include_first_stage=vae_bf16)
    if clip_size is not None:
        model.num_samples = int(clip_size)
    return model


def add_turbo_arguments(p: argparse.ArgumentParser) -> None:
    """--encoder_reuse and --cfg_interval, the opt-in approximations of every
    inference CLI (off by default: the exact reference semantics)."""
    p.add_argument("--encoder_reuse", type=int, default=0,
                   help="turbo: run the UNet encoder only every k-th sampler step, decode the "
                        "rest from cached features (Faster Diffusion; APPROXIMATE for k >= 2; "
                        "0 = exact reference semantics)")
    p.add_argument("--cfg_interval", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                   help="turbo: apply CFG only on steps with sigma in [LO, HI], a single "
                        "conditioned UNet pass elsewhere (guidance interval, arXiv 2404.07724; "
                        "APPROXIMATE unless the interval covers the whole sigma schedule)")
