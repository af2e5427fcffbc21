"""Per-σ loss weightings (counterpart of hi3d_tpu/diffusion/weighting.py).
Hi3D trains with VWeighting (EDM weighting with σ_data = 1)."""

from __future__ import annotations

import torch


class UnitWeighting:
    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(sigma)


class EDMWeighting:
    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = float(sigma_data)

    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return (sigma**2 + self.sigma_data**2) / (sigma * self.sigma_data) ** 2


class VWeighting(EDMWeighting):
    def __init__(self):
        super().__init__(sigma_data=1.0)


class EpsWeighting:
    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma**-2.0
