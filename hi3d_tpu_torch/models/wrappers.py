"""Network wrappers (counterpart of hi3d_tpu/models/wrappers.py). Each holds
the UNet as `diffusion_model`, so the engine's state dict reads
`model.diffusion_model.*` like the reference's.

- `ConcatConditionWrapper` (the reference's `OpenAIWrapper`) concatenates
  cond["concat"] onto x along channels and maps crossattn → context,
  vector → y;
- `IdentityWrapper` calls the UNet on (x, c_noise) and the extra keyword
  arguments alone: it drops `cond`, as the JAX package's does."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


class IdentityWrapper(nn.Module):
    def __init__(self, diffusion_model: nn.Module, compile_model: bool = False):
        super().__init__()
        self.diffusion_model = diffusion_model

    def forward(self, x: torch.Tensor, c_noise: torch.Tensor, cond: Dict, **kwargs):
        return self.diffusion_model(x, c_noise, **kwargs)


class ConcatConditionWrapper(IdentityWrapper):
    def forward(self, x: torch.Tensor, c_noise: torch.Tensor, cond: Dict, **kwargs):
        if "concat" in cond:
            x = torch.cat([x, cond["concat"].to(x.dtype)], dim=1)
        return self.diffusion_model(
            x, c_noise, context=cond.get("crossattn"), y=cond.get("vector"), **kwargs
        )
