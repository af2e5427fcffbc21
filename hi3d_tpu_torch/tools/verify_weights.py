"""Checkpoint coverage of the released weights for the PyTorch port (the
port's counterpart of tools/verify_weights.py).

For every artifact the reference expects under `ckpts/`, build the port's
module on the `meta` device (no memory, no initialisation), read the file
with the port's own loaders (`convert.load_checkpoint_file`, which reads
`.safetensors` without the package and unwraps DeepSpeed's `module.`
layout; `load_dpt_state_dict`; `load_u2net`; the towers' `visual.` keys),
report the keys matched, missing and unexpected and the shape mismatches,
and load the file with `load_state_dict(strict=True, assign=True)`. An
artifact is PASS when every key of its module is matched at its shape and the
strict load succeeds, FAIL otherwise, SKIP when the file is absent, so the
tool runs anywhere; with the real checkpoints in `ckpts/` it is the first-day
check. `--smoke` then samples 2 steps at 8 × 256² with the stage-1 weights on
`--device`.

    python -m hi3d_tpu_torch.tools.verify_weights [--ckpt_dir ckpts] [--smoke] \\
        [--device cuda] [--stage1 configs/inference-v01.yaml] \\
        [--stage2 configs/inference-v02.yaml]

An engine checkpoint (`first_stage.pt`, `second_stage.pt`, the SVD
initialisations of train-v01 and train-v02) is checked as
`engine.init_from_ckpt` loads it: each engine part it holds (the UNet under
`model.diffusion_model.`, the VAE under `first_stage_model.`, the embedders
that load from it under `conditioner.embedders.N.`) strictly; keys under no
part are counted and not loaded.
"""

from __future__ import annotations

import argparse
import os
import traceback
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

Result = Tuple[str, str, str]  # (artifact, PASS/SKIP/FAIL, detail)


class CoverageError(ValueError):
    """A state dict that does not cover its module exactly."""


def coverage(module: nn.Module, sd: Mapping[str, torch.Tensor]) -> str:
    """Matched / missing / unexpected keys and shape mismatches of `sd`
    against `module` (on the meta device); then a strict load that assigns
    the file's tensors. Raises CoverageError, with the report, when the
    keys or shapes differ."""
    own = module.state_dict()
    matched = [k for k in sd if k in own]
    missing = [k for k in own if k not in sd]
    unexpected = [k for k in sd if k not in own]
    bad = [k for k in matched if tuple(own[k].shape) != tuple(sd[k].shape)]
    detail = (f"{len(matched)}/{len(own)} keys matched, {len(missing)} missing, "
              f"{len(unexpected)} unexpected")
    if bad:
        detail += f", {len(bad)} SHAPE MISMATCHES e.g. {bad[:3]}"
    if missing:
        detail += f"; missing e.g. {missing[:3]}"
    if unexpected:
        detail += f"; unexpected e.g. {unexpected[:3]}"
    if missing or unexpected or bad:
        raise CoverageError(detail)
    module.load_state_dict(dict(sd), strict=True, assign=True)
    return detail


def _check(results: List[Result], name: str, path: str, fn: Callable[[], str]) -> None:
    if not os.path.exists(path):
        results.append((name, "SKIP", f"{path} not found"))
        return
    try:
        results.append((name, "PASS", fn()))
    except Exception as e:  # a report row, never an abort of the other artifacts
        where = traceback.format_exc().strip().split("\n")[-1]
        detail = f"{type(e).__name__}: {e}"
        results.append((name, "FAIL", detail if isinstance(e, CoverageError)
                        else f"{detail} ({where})"))


def build_engine_on_meta(config_path: str):
    """The config's engine on the meta device, without its `ckpt_path`."""
    from ..config import instantiate_from_config, load_config

    cfg = load_config(config_path)["model"]
    params = {k: v for k, v in (cfg.get("params") or {}).items() if k != "ckpt_path"}
    with torch.device("meta"):
        return instantiate_from_config({"target": cfg["target"], "params": params})


def verify_engine_ckpt(config_path: str, ckpt_path: str) -> str:
    """Each engine part the checkpoint holds, strictly (as
    `init_from_ckpt` loads it)."""
    from ..convert import load_checkpoint_file

    engine = build_engine_on_meta(config_path)
    sd = load_checkpoint_file(ckpt_path)
    parts = [("unet", "model.diffusion_model.", engine.model.diffusion_model),
             ("vae", "first_stage_model.", engine.first_stage_model)]
    if engine.conditioner is not None:
        parts += [(f"embedder {n}", f"conditioner.embedders.{n}.", emb)
                  for n, emb in enumerate(engine.conditioner.embedders)
                  if emb.loads_engine_checkpoint]
    reports, errors, used = [], [], set()
    for label, prefix, module in parts:
        sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if not sub:
            continue
        used.update(prefix + k for k in sub)
        try:
            reports.append(f"{label}: {coverage(module, sub)}")
        except CoverageError as e:
            errors.append(f"{label}: {e}")
    if not reports and not errors:
        raise CoverageError(f"none of the engine's parts in {len(sd)} keys")
    other = len(sd) - len(used)
    tail = f"; {other} keys under no engine part (not loaded)" if other else ""
    if errors:
        raise CoverageError("; ".join(errors + reports) + tail)
    return "; ".join(reports) + tail


def _visual(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CLIP file's vision tower, as the embedders read it (`visual.`)."""
    return {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}


def _towers() -> Dict[str, Callable[[], nn.Module]]:
    from ..models.clip import AestheticMLP, vit_h_14, vit_l_14
    from ..models.dpt import DPTDepthModel

    return {"clip_h": vit_h_14, "clip_l": vit_l_14, "aesthetic": AestheticMLP,
            "dpt": DPTDepthModel}


def _on_meta(build: Callable[[], nn.Module]) -> nn.Module:
    with torch.device("meta"):
        return build()


def smoke_stage1(config_path: str, ckpt_path: str, device: str = "cuda") -> str:
    """2 sampler steps at 8 × 256² with the stage-1 checkpoint on `device`."""
    import numpy as np

    from ..pipelines.common import load_inference_model
    from ..pipelines.i2v import generate_orbit

    model = load_inference_model(config_path, ckpt_path, device=device, tag="verify",
                                 clip_size=8)
    frames = np.zeros((8, 256, 256, 3), np.float32)
    generator = torch.Generator(device=model.device).manual_seed(0)
    out = generate_orbit(model, frames, generator=generator, num_steps=2)
    if not np.isfinite(out).all():
        raise ValueError("non-finite frames from the 2-step smoke")
    return f"2-step sample finite, out {out.shape} on {model.device}"


def verify(ckpt_dir: str = "ckpts", stage1_cfg: str = "configs/inference-v01.yaml",
           stage2_cfg: str = "configs/inference-v02.yaml", smoke: bool = False,
           device: str = "cuda",
           towers: Optional[Dict[str, Callable[[], nn.Module]]] = None) -> List[Result]:
    """One row per artifact. `towers` replaces the module builders of
    "clip_h", "clip_l", "aesthetic" and "dpt" (smaller towers in tests)."""
    from ..convert import load_dpt_state_dict, load_u2net
    from ..models.u2net import U2Net

    build = {**_towers(), **(towers or {})}
    results: List[Result] = []

    def p(*xs):
        return os.path.join(ckpt_dir, *xs)

    first, second = p("first_stage.pt"), p("second_stage.pt")
    _check(results, "stage1 engine (first_stage.pt)", first,
           lambda: verify_engine_ckpt(stage1_cfg, first))
    _check(results, "stage2 engine (second_stage.pt)", second,
           lambda: verify_engine_ckpt(stage2_cfg, second))

    clip_h = p("open_clip_pytorch_model.bin")
    _check(results, "OpenCLIP ViT-H (open_clip_pytorch_model.bin)", clip_h,
           lambda: coverage(_on_meta(build["clip_h"]),
                            _visual(torch.load(clip_h, map_location="cpu", weights_only=True))))
    clip_l = p("ViT-L-14.pt")
    _check(results, "CLIP ViT-L (ViT-L-14.pt)", clip_l,
           lambda: coverage(_on_meta(build["clip_l"]),
                            _visual(torch.jit.load(clip_l, map_location="cpu").state_dict())))
    aes = p("metric_models", "sac+logos+ava1-l14-linearMSE.pth")
    _check(results, "aesthetic MLP (sac+logos+ava1)", aes,
           lambda: coverage(_on_meta(build["aesthetic"]),
                            torch.load(aes, map_location="cpu", weights_only=True)))
    dpt = p("dpt_hybrid_384.pt")
    _check(results, "DPT-hybrid depth (dpt_hybrid_384.pt)", dpt,
           lambda: coverage(_on_meta(build["dpt"]), load_dpt_state_dict(dpt)))
    for name in ("u2net.pth", "u2netp.pth"):
        path = p(name)

        def check_u2net(path=path) -> str:
            sd, full = load_u2net(path)
            return coverage(_on_meta(lambda: U2Net(full=full)), sd)

        _check(results, f"U2Net background removal ({name})", path, check_u2net)
    for name, cfg in (("svd_xt_image_decoder.safetensors", stage1_cfg),
                      ("svd_xt_image_decoder_vid2vid.safetensors", stage2_cfg)):
        path = p(name)
        _check(results, f"training init ({name})", path,
               lambda path=path, cfg=cfg: verify_engine_ckpt(cfg, path))
    if smoke:
        _check(results, "stage1 2-step sampling smoke", first,
               lambda: smoke_stage1(stage1_cfg, first, device))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt_dir", default="ckpts")
    ap.add_argument("--stage1", default="configs/inference-v01.yaml")
    ap.add_argument("--stage2", default="configs/inference-v02.yaml")
    ap.add_argument("--smoke", action="store_true", help="also sample 2 steps with first_stage.pt")
    ap.add_argument("--device", default="cuda", help="the smoke's device")
    args = ap.parse_args(argv)

    results = verify(args.ckpt_dir, args.stage1, args.stage2, smoke=args.smoke,
                     device=args.device)
    w = max(len(r[0]) for r in results) + 2
    print("\n" + "=" * (w + 60))
    for name, status, detail in results:
        print(f"{name:<{w}} {status:<5} {detail}")
    print("=" * (w + 60))
    failed = [r for r in results if r[1] == "FAIL"]
    passed = [r for r in results if r[1] == "PASS"]
    print(f"{len(passed)} passed, {len(failed)} failed, "
          f"{len(results) - len(passed) - len(failed)} skipped")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
