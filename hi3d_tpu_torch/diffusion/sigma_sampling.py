"""Training-time σ samplers (counterpart of hi3d_tpu/diffusion/sigma_sampling.py).

Draws come from a `torch.Generator` (the JAX package takes PRNG keys); `rand`
pins the underlying normal / index draw, as the JAX samplers allow.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import instantiate_from_config


class EDMSampling:
    """Lognormal σ: σ = exp(p_mean + p_std · N(0, 1))."""

    def __init__(self, p_mean: float = -1.2, p_std: float = 1.2):
        self.p_mean = float(p_mean)
        self.p_std = float(p_std)

    def __call__(self, n_samples: int, generator: Optional[torch.Generator] = None,
                 rand: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
        if rand is None:
            rand = torch.randn((n_samples,), generator=generator, device=device)
        return torch.exp(self.p_mean + self.p_std * rand.float())


class DiscreteSampling:
    """Uniformly one of `num_idx` discretised σ levels."""

    def __init__(self, discretization_config: Dict, num_idx: int, do_append_zero: bool = False,
                 flip: bool = True):
        self.num_idx = int(num_idx)
        self.sigmas = instantiate_from_config(discretization_config)(
            self.num_idx, do_append_zero=do_append_zero, flip=flip
        )

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return self.sigmas.to(idx.device)[idx]

    def __call__(self, n_samples: int, generator: Optional[torch.Generator] = None,
                 rand: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
        if rand is None:
            rand = torch.randint(0, self.num_idx, (n_samples,), generator=generator,
                                 device=device)
        return self.idx_to_sigma(rand)
