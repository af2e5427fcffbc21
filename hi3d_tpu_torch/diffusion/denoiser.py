"""D(x, σ) = network(x·c_in, c_noise, cond)·c_out + x·c_skip
(counterpart of hi3d_tpu/diffusion/denoiser.py). Coefficients are fp32 and
cast to the activation dtype only at the multiply."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..config import instantiate_from_config
from ..utils.misc import append_dims


class Denoiser:
    def __init__(self, scaling_config: Dict):
        self.scaling = instantiate_from_config(scaling_config)

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return c_noise

    def __call__(self, network: Callable, x: torch.Tensor, sigma: torch.Tensor,
                 cond: Dict, **additional_model_inputs) -> torch.Tensor:
        sigma = self.possibly_quantize_sigma(sigma.to(torch.float32))
        sigma_shape = sigma.shape
        c_skip, c_out, c_in, c_noise = self.scaling(append_dims(sigma, x.ndim))
        c_noise = self.possibly_quantize_c_noise(c_noise.reshape(sigma_shape))
        out = network(x * c_in.to(x.dtype), c_noise, cond, **additional_model_inputs)
        return out * c_out.to(out.dtype) + x.to(out.dtype) * c_skip.to(out.dtype)


class DiscreteDenoiser(Denoiser):
    """Quantizes σ to the nearest level of a discretization before scaling;
    with `quantize_c_noise` the network gets that level's index as c_noise."""

    def __init__(self, scaling_config: Dict, num_idx: int, discretization_config: Dict,
                 do_append_zero: bool = False, quantize_c_noise: bool = True, flip: bool = True):
        super().__init__(scaling_config)
        self.sigmas = instantiate_from_config(discretization_config)(
            num_idx, do_append_zero=do_append_zero, flip=flip)
        self.quantize_c_noise = quantize_c_noise
        self.num_idx = int(num_idx)

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        dists = sigma - self.sigmas.to(sigma.device)[:, None]
        return dists.abs().argmin(dim=0).reshape(sigma.shape)

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return self.sigmas.to(idx.device)[idx]

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.idx_to_sigma(self.sigma_to_idx(sigma))

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        if self.quantize_c_noise:
            return self.sigma_to_idx(c_noise).to(torch.float32)
        return c_noise
