"""Loading reference-layout state dicts into the port's modules.

The port's parameter names are the reference's torch names, so a released
DeepSpeed checkpoint (after its `module.` prefix is stripped) and a state
dict exported from the JAX package
(hi3d_tpu/convert/jax_to_torch.py:export_engine_state_dict) both load
without renaming; this module only selects, casts and checks.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

ENGINE_PREFIXES = ("model.diffusion_model.", "first_stage_model.", "conditioner.embedders.")


def strip_deepspeed(sd: Mapping[str, object]) -> Dict[str, object]:
    """Drop the DeepSpeed `module.` prefix where present."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_checkpoint_file(path: str) -> Dict[str, torch.Tensor]:
    """A .pt/.ckpt file as a flat state dict (DeepSpeed `{'module': ...}` and
    Lightning `{'state_dict': ...}` wrappers unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and isinstance(sd.get("module"), dict):
        sd = sd["module"]
    return {k: v for k, v in strip_deepspeed(sd).items() if hasattr(v, "shape")}


def load_reference_state_dict(module: nn.Module, sd: Mapping[str, object], prefix: str = "") -> None:
    """Load the entries of `sd` under `prefix` into `module` with strict=True.

    Values may be numpy arrays or torch tensors; each is cast to the dtype and
    device of the parameter it replaces. `module.` prefixes are stripped."""
    sd = strip_deepspeed(sd)
    own = module.state_dict()
    picked = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        t = torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v
        ref = own.get(name)
        picked[name] = t.to(dtype=ref.dtype, device=ref.device) if ref is not None else t
    module.load_state_dict(picked, strict=True)


# keys of the ViT classifier in MiDaS's timm backbone: DPT reads the hooked
# block outputs only, never the final norm or the head
DPT_CLASSIFIER_PREFIXES = ("pretrained.model.norm.", "pretrained.model.fc_norm.",
                           "pretrained.model.head.", "pretrained.model.pre_logits.")


def load_dpt_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """MiDaS `dpt_hybrid_384.pt` as the state dict of
    models.dpt.DPTDepthModel, whose names are MiDaS's: the `{"model": ...,
    "optimizer": ...}` training wrapper is unwrapped and the classifier keys
    (`DPT_CLASSIFIER_PREFIXES`) are dropped. Nothing else is renamed or
    dropped, so `load_state_dict(..., strict=True)` rejects any other
    difference."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict) and "optimizer" in sd:
        sd = sd["model"]
    return {k: v for k, v in strip_deepspeed(sd).items()
            if not k.startswith(DPT_CLASSIFIER_PREFIXES)}
