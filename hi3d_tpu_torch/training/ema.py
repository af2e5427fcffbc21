"""Exponential moving average of parameters (counterpart of
hi3d_tpu/training/ema.py): s ← s − (1 − d)·(s − p) with the warm-up decay
d = min(decay, (1 + n)/(10 + n)), n the number of updates so far (after this
one). The shadow tensors are updated in place."""

from __future__ import annotations

from typing import List, Sequence

import torch


@torch.no_grad()
def ema_update(ema_params: List[torch.Tensor], params: Sequence[torch.Tensor],
               num_updates: int, decay: float = 0.9999) -> List[torch.Tensor]:
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    torch._foreach_lerp_(ema_params, [p.to(s.dtype) for s, p in zip(ema_params, params)], 1.0 - d)
    return ema_params
