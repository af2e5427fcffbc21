"""Checkpoint surgery: an SVD image-to-video checkpoint → the stage-2
vid2vid initialisation (the port's counterpart of
tools/make_init_svd_to_vid2vid.py, on torch tensors):

- `label_emb.0.0.weight` (·, 768) → (·, 512): the first 256 columns zeroed
  (the elevation slot), columns 512: kept (the cond_aug slot);
- `diffusion_model.input_blocks.0.0.weight` (·, 8, 3, 3) → (·, 17, 3, 3):
  [4 latent channels, 9 zero depth channels, the 4 concat channels];
- every other tensor copies through unchanged.

Reads and writes `.safetensors` through hi3d_tpu_torch.convert (no
`safetensors` package needed):

    python -m hi3d_tpu_torch.tools.make_init_svd_to_vid2vid <svd.safetensors> <out.safetensors>
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Mapping

import torch


def surgery(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, w in sd.items():
        if "label_emb.0.0.weight" in k:
            if w.shape[1] != 768:
                raise ValueError(f"{k}: expected 768 input columns, got shape {tuple(w.shape)}")
            w = torch.cat([torch.zeros_like(w[:, :256]), w[:, 512:]], dim=1)
        if "diffusion_model.input_blocks.0.0.weight" in k:
            if w.shape[1] != 8:
                raise ValueError(f"{k}: expected 8 input channels, got shape {tuple(w.shape)}")
            depth = w.new_zeros((w.shape[0], 9, *w.shape[2:]))
            w = torch.cat([w[:, :4], depth, w[:, 4:]], dim=1)
        out[k] = w
    return out


def main(argv=None) -> None:
    from ..convert import load_checkpoint_file, save_safetensors

    p = argparse.ArgumentParser(description="SVD checkpoint → stage-2 vid2vid initialisation")
    p.add_argument("input", help="svd_xt_image_decoder.safetensors (or .pt/.ckpt)")
    p.add_argument("output", help="the adapted .safetensors to write")
    args = p.parse_args(argv)
    if not os.path.exists(args.input):
        raise FileNotFoundError(f"input model {args.input!r} does not exist")
    if os.path.exists(args.output):
        raise FileExistsError(f"output {args.output!r} already exists")
    out = surgery(load_checkpoint_file(args.input))
    save_safetensors(out, args.output)
    print(f"wrote {args.output} ({len(out)} tensors)")


if __name__ == "__main__":
    main()
