"""σ schedules (counterpart of hi3d_tpu/diffusion/discretization.py).

`get_sigmas(n)` is float32 numpy on the host; calling a discretization
returns the schedule as a float32 tensor on the caller's device."""

from __future__ import annotations

import numpy as np
import torch


class Discretization:
    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False,
                 device=None) -> torch.Tensor:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = np.append(sigmas, np.float32(0.0))
        if flip:
            sigmas = sigmas[::-1].copy()
        return torch.as_tensor(sigmas, dtype=torch.float32, device=device)

    def get_sigmas(self, n: int) -> np.ndarray:
        raise NotImplementedError


class EDMDiscretization(Discretization):
    """Karras ρ-schedule: σ_i = (σ_max^(1/ρ) + i/(n-1)·(σ_min^(1/ρ) − σ_max^(1/ρ)))^ρ."""

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0):
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rho = float(rho)

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0, 1, n, dtype=np.float64)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        return ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** self.rho).astype(np.float32)


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2) -> np.ndarray:
    """Linear-in-sqrt β schedule, float64."""
    if schedule != "linear":
        raise NotImplementedError(f"schedule '{schedule}' unknown.")
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    """Evenly spaced timestep subset, ascending."""
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


class LegacyDDPMDiscretization(Discretization):
    """σ-schedule derived from the DDPM ᾱ products (descending σ)."""

    def __init__(self, linear_start: float = 0.00085, linear_end: float = 0.0120,
                 num_timesteps: int = 1000):
        self.num_timesteps = int(num_timesteps)
        betas = make_beta_schedule("linear", self.num_timesteps, linear_start=linear_start,
                                   linear_end=linear_end)
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)

    def get_sigmas(self, n: int) -> np.ndarray:
        if n < self.num_timesteps:
            alphas_cumprod = self.alphas_cumprod[
                generate_roughly_equally_spaced_steps(n, self.num_timesteps)]
        elif n == self.num_timesteps:
            alphas_cumprod = self.alphas_cumprod
        else:
            raise ValueError(f"n={n} exceeds num_timesteps={self.num_timesteps}")
        sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
        return np.flip(sigmas, 0).astype(np.float32).copy()
