"""Denoiser preconditioning (counterpart of hi3d_tpu/diffusion/scaling.py).

Each scaling maps σ to (c_skip, c_out, c_in, c_noise), in fp32 whatever the
activation dtype, such that D(x, σ) = network(x·c_in, c_noise)·c_out + x·c_skip."""

from __future__ import annotations

import torch


class EDMScaling:
    """Karras et al. (2022) preconditioning with data std σ_data."""

    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = float(sigma_data)

    def __call__(self, sigma: torch.Tensor):
        sigma = sigma.to(torch.float32)
        sd2 = self.sigma_data**2
        c_skip = sd2 / (sigma**2 + sd2)
        c_out = sigma * self.sigma_data * torch.rsqrt(sigma**2 + sd2)
        c_in = torch.rsqrt(sigma**2 + sd2)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise


class EpsScaling:
    """ε-prediction scaling (DDPM-style)."""

    def __call__(self, sigma: torch.Tensor):
        sigma = sigma.to(torch.float32)
        c_skip = torch.ones_like(sigma)
        c_out = -sigma
        c_in = torch.rsqrt(sigma**2 + 1.0)
        c_noise = sigma
        return c_skip, c_out, c_in, c_noise


class VScaling:
    """v-prediction scaling with c_noise = σ."""

    def __call__(self, sigma: torch.Tensor):
        sigma = sigma.to(torch.float32)
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = -sigma * torch.rsqrt(sigma**2 + 1.0)
        c_in = torch.rsqrt(sigma**2 + 1.0)
        c_noise = sigma
        return c_skip, c_out, c_in, c_noise


class VScalingWithEDMcNoise:
    """v-prediction scaling with the EDM noise embedding c_noise = 0.25·log σ,
    in fp32: returns (c_skip, c_out, c_in, c_noise)."""

    def __call__(self, sigma: torch.Tensor):
        sigma = sigma.to(torch.float32)
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = -sigma * torch.rsqrt(sigma**2 + 1.0)
        c_in = torch.rsqrt(sigma**2 + 1.0)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise
