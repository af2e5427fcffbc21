"""Trainable-parameter selection and the optimizer (counterpart of
hi3d_tpu/training/state.py).

The port's parameter names are the reference's torch names, so the
reference's rule applies as written (vtdm_gen_v01.py:169-182): 'all' trains
every UNet parameter; otherwise a parameter of `engine.model` (names
`diffusion_model.…`) trains iff one of `trained_param_keys` is a substring of
its name. Everything else — the rest of the UNet, the VAE, the conditioner
towers — gets `requires_grad_(False)`, the counterpart of the JAX package's
`freeze_frozen`, so autograd computes no gradient for it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from ..parallel import dist as pdist
from ..parallel.zero import ZeroAdamW


def trainable_mask(model: nn.Module, trained_param_keys: Sequence[str]) -> Dict[str, bool]:
    """{parameter name of `model`: trains?}."""
    keys = list(trained_param_keys)
    return {name: "all" in keys or any(k in name for k in keys)
            for name, _ in model.named_parameters()}


def freeze_frozen(engine: nn.Module,
                  trained_param_keys: Sequence[str]) -> List[Tuple[str, nn.Parameter]]:
    """Set requires_grad on the engine's parameters: only the UNet parameters
    that `trained_param_keys` selects train. Returns those (name, parameter)
    pairs, names relative to `engine.model`."""
    engine.requires_grad_(False)
    mask = trainable_mask(engine.model, trained_param_keys)
    trainable = [(n, p) for n, p in engine.model.named_parameters() if mask[n]]
    for _, p in trainable:
        p.requires_grad_(True)
    return trainable


def build_optimizer(params, learning_rate: float, weight_decay: float = 1e-2,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.optim.AdamW:
    """AdamW with PyTorch's default hyper-parameters (reference
    sgm/models/diffusion.py:44-47), over the trainable parameters only.
    Inside a process group its state is sharded over the ranks
    (`parallel.zero.ZeroAdamW`, the same AdamW on each rank's slice)."""
    opt = ZeroAdamW if pdist.initialized() else torch.optim.AdamW
    return opt(list(params), lr=learning_rate, betas=(b1, b2), eps=eps,
               weight_decay=weight_decay)
