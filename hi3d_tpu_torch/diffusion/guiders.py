"""Classifier-free guidance (counterpart of hi3d_tpu/diffusion/guiders.py).

The batch doubles as cat([uc, c]) along dim 0; the guider splits the network
output back into its halves and blends them. `frames` (a
`parallel.dist.FrameShard`) says which frames of the batch the rows are when
a rank holds only some of them: the per-frame scale then follows each row's
frame within its video."""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from ..utils.misc import append_dims

_BATCHED_COND_KEYS = ("vector", "crossattn", "concat")


def _merge_cond(c: Dict, uc: Dict, extra_keys=()) -> Dict:
    """cat([uc, c]) of the batched keys; the other keys pass through from c."""
    return {k: torch.cat([uc[k], c[k]], dim=0) if k in _BATCHED_COND_KEYS or k in extra_keys
            else c[k] for k in c}


class IdentityGuider:
    def __call__(self, x: torch.Tensor, sigma: torch.Tensor, frames=None) -> torch.Tensor:
        return x

    def prepare_inputs(self, x, s, c: Dict, uc: Dict):
        return x, s, dict(c)


class VanillaCFG:
    """Single-scale CFG: pred = uc + scale · (c − uc)."""

    def __init__(self, scale: float):
        self.scale = float(scale)

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor, frames=None) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        return x_u + self.scale * (x_c - x_u)

    def prepare_inputs(self, x, s, c: Dict, uc: Dict):
        return torch.cat([x, x], dim=0), torch.cat([s, s], dim=0), _merge_cond(c, uc)


class LinearPredictionGuider:
    """Per-frame CFG scale rising linearly from min_scale to max_scale over T."""

    def __init__(self, max_scale: float, num_frames: int, min_scale: float = 1.0,
                 additional_cond_keys: Optional[Union[List[str], str]] = None):
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.num_frames = int(num_frames)
        self.scale = torch.linspace(self.min_scale, self.max_scale, self.num_frames,
                                    dtype=torch.float32)
        keys = additional_cond_keys or []
        self.additional_cond_keys = tuple([keys] if isinstance(keys, str) else keys)

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor, frames=None) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        if frames is not None:  # this rank's rows: each takes its own frame's scale
            idx = frames.frame_index(frames.copies(x_u.shape[0]), x.device)
            scale = append_dims(self.scale.to(x.device)[idx], x_u.ndim).to(x_u.dtype)
            return x_u + scale * (x_c - x_u)
        t = self.num_frames
        b = x_u.shape[0] // t
        x_u = x_u.reshape((b, t) + x_u.shape[1:])
        x_c = x_c.reshape((b, t) + x_c.shape[1:])
        scale = append_dims(self.scale[None, :].to(x.device), x_u.ndim).to(x_u.dtype)
        out = x_u + scale * (x_c - x_u)
        return out.reshape((b * t,) + out.shape[2:])

    def prepare_inputs(self, x, s, c: Dict, uc: Dict):
        return (torch.cat([x, x], dim=0), torch.cat([s, s], dim=0),
                _merge_cond(c, uc, self.additional_cond_keys))
