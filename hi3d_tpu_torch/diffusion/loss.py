"""Training loss for the denoiser (counterpart of hi3d_tpu/diffusion/loss.py).

StandardDiffusionLoss: one σ per *video*, repeated over its T frames; noise
added at that σ; the denoiser's output weighted per σ and reduced to a
per-frame L2 or L1, or the LPIPS distance (unweighted) of 3-channel
outputs. `network` is the wrapped UNet with the batch's bound
keyword arguments, `cond` the conditioner's output; latents are NCHW.

`parity_sigmas` ((B,) per-video σ before the repeat) and `parity_noise`
(input-shaped ε) pin the two random draws, as in the JAX package, so tests
can feed both packages the same σ and ε.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch

from ..config import instantiate_from_config
from ..utils.misc import append_dims


class StandardDiffusionLoss:
    def __init__(
        self,
        sigma_sampler_config: Dict,
        loss_weighting_config: Dict,
        loss_type: str = "l2",
        offset_noise_level: float = 0.0,
        batch2model_keys: Optional[Union[str, List[str]]] = None,
        num_frames: int = 1,
    ):
        if loss_type not in ("l2", "l1", "lpips"):
            raise ValueError(f"loss_type {loss_type!r}")
        if loss_type == "lpips":
            # a perceptual distance for pixel-space models, built once from
            # seed 0 (the JAX package initialises its LPIPS from PRNGKey(0));
            # load trained weights with models.lpips.load_lpips_params
            from ..models.lpips import LPIPS

            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                self.lpips = LPIPS()
        self.sigma_sampler = instantiate_from_config(sigma_sampler_config)
        self.loss_weighting = instantiate_from_config(loss_weighting_config)
        self.loss_type = loss_type
        self.offset_noise_level = float(offset_noise_level)
        if isinstance(batch2model_keys, str):
            batch2model_keys = [batch2model_keys]
        self.batch2model_keys = set(batch2model_keys or [])
        self.num_frames = int(num_frames)
        self.parity_sigmas: Optional[torch.Tensor] = None
        self.parity_noise: Optional[torch.Tensor] = None

    def __call__(self, network: Callable, denoiser, cond: Dict, input: torch.Tensor,
                 batch: Dict, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-frame loss, shape (B·T,)."""
        additional = {k: batch[k] for k in self.batch2model_keys.intersection(batch)}
        device = input.device
        b = input.shape[0] // self.num_frames
        if self.parity_sigmas is not None:
            sigmas = torch.as_tensor(self.parity_sigmas, dtype=torch.float32, device=device)
        else:
            sigmas = self.sigma_sampler(b, generator=generator, device=device)
        sigmas = sigmas.repeat_interleave(self.num_frames, dim=0)  # one σ per video

        if self.parity_noise is not None:
            noise = torch.as_tensor(self.parity_noise, device=device).to(input.dtype)
        else:
            noise = torch.randn(input.shape, generator=generator, device=device, dtype=input.dtype)
        if self.offset_noise_level > 0.0:
            offset = torch.randn((input.shape[0],), generator=generator, device=device,
                                 dtype=input.dtype)
            noise = noise + self.offset_noise_level * append_dims(offset, input.ndim)

        noised = input + noise * append_dims(sigmas, input.ndim).to(input.dtype)
        model_output = denoiser(network, noised, sigmas, cond, **additional)
        w = append_dims(self.loss_weighting(sigmas), input.ndim)
        return self.get_loss(model_output, input, w)

    def get_loss(self, model_output: torch.Tensor, target: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
        if self.loss_type == "lpips":
            # no σ-weighting on this branch; (B,). LPIPS raises a ValueError
            # on outputs without 3 channels, where the JAX package fails to
            # broadcast its RGB shift
            self.lpips.to(model_output.device)
            return self.lpips(model_output.float(), target.float())
        diff = model_output.float() - target.float()
        per = w * (diff**2 if self.loss_type == "l2" else diff.abs())
        return per.reshape(target.shape[0], -1).mean(dim=1)
