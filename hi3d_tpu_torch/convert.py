"""Loading reference-layout state dicts into the port's modules.

The port's parameter names are the reference's torch names, so a released
DeepSpeed checkpoint (after its `module.` prefix is stripped) and a state
dict exported from the JAX package
(hi3d_tpu/convert/jax_to_torch.py:export_engine_state_dict) both load
without renaming; this module only selects, casts and checks.

`.safetensors` files are read and written here (`read_safetensors`,
`save_safetensors`) without the `safetensors` package: the format is an
8-byte little-endian header length, a JSON header of `{name: {dtype, shape,
data_offsets}}` (plus an optional `__metadata__` of strings) and the raw
little-endian tensor bytes, offsets counted from the end of the header.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

ENGINE_PREFIXES = ("model.diffusion_model.", "first_stage_model.", "conditioner.embedders.")


def strip_deepspeed(sd: Mapping[str, object]) -> Dict[str, object]:
    """Drop the DeepSpeed `module.` prefix where present."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_SAFETENSORS_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}
_MAX_HEADER = 100 * 2**20  # the format's own limit on the JSON header


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file as {name: CPU tensor}, one read per tensor."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: safetensors header of {n} bytes")
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
            shape = [int(d) for d in info["shape"]]
            start, end = (int(o) for o in info["data_offsets"])
            numel = 1
            for d in shape:
                numel *= d
            if end - start != numel * dtype.itemsize:
                raise ValueError(f"{path}: tensor {name!r} spans {end - start} bytes, its "
                                 f"shape {shape} and dtype {info['dtype']} need "
                                 f"{numel * dtype.itemsize}")
            buf = bytearray(end - start)
            f.seek(base + start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(shape)
    return out


def save_safetensors(sd: Mapping[str, torch.Tensor], path: str) -> None:
    """Write {name: tensor} as a `.safetensors` file that the `safetensors`
    package reads; tensors are laid out in name order and written one at a
    time."""
    header: Dict[str, object] = {}
    offset = 0
    for name in sorted(sd):
        t = sd[name]
        if t.dtype not in _SAFETENSORS_NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data section starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in sorted(sd):
            t = sd[name].detach().to("cpu").contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def export_engine_state_dict(engine: nn.Module) -> Dict[str, torch.Tensor]:
    """The engine's UNet under `model.diffusion_model.` and its VAE under
    `first_stage_model.`, fp32 on the CPU: the reference layout that
    `--outckpt` writes and `init_from_ckpt` loads (the JAX package's
    `export_engine_state_dict`)."""
    sd: Dict[str, torch.Tensor] = {}
    for prefix, module in (("model.diffusion_model.", engine.model.diffusion_model),
                           ("first_stage_model.", engine.first_stage_model)):
        sd.update({prefix + k: v.detach().to("cpu", torch.float32)
                   for k, v in module.state_dict().items()})
    return sd


def load_checkpoint_file(path: str) -> Dict[str, torch.Tensor]:
    """A .pt/.ckpt/.safetensors file as a flat state dict (DeepSpeed
    `{'module': ...}` and Lightning `{'state_dict': ...}` wrappers
    unwrapped). `.safetensors` goes through `read_safetensors`, never
    `torch.load`."""
    if str(path).endswith(".safetensors"):
        return strip_deepspeed(read_safetensors(path))
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


def load_u2net(path: str) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A released `u2net.pth` / `u2netp.pth` as (state dict of
    models.u2net.U2Net, full): the light u2netp variant when the file's name
    contains "u2netp", the full model otherwise (as the JAX package decides).
    The names are upstream's, so the dict loads with strict=True."""
    import os

    return load_checkpoint_file(path), "u2netp" not in os.path.basename(path)


# --- flax variable trees (as numpy arrays) → the port's modules -------------

# flax leaf names → torch names where the module has no leaf of the flax name
# (ActNorm's `scale` and `loc`, a block's `mix_factor` keep theirs)
_FLAX_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
                "mean": "running_mean", "var": "running_var"}
_FLAX_BLOCK = re.compile(r"^(up|down)_(\d+)_(block|attn)_(\d+)$")
_FLAX_RESAMPLE = re.compile(r"^(up|down)_(\d+)_(upsample|downsample)$")
_FLAX_INDEXED = re.compile(r"^(\w+?)_(\d+)$")


def flax_module_name(path: Tuple[str, ...]) -> str:
    """The port's dotted module name of a flax module path: VAE towers
    (`up_3_block_0` → `up.3.block.0`, `mid_attn_1` → `mid.attn_1`,
    `up_1_upsample` → `up.1.upsample`), `name_N` → `name.N` (`in_layers_0`,
    `to_out_0`, `net_0`, `video_time_embed_2`), and the norms' inner fp32
    wrapper scope `norm` dropped."""
    out = []
    for i, seg in enumerate(path):
        if seg == "norm" and i == len(path) - 1 and i > 0:
            continue  # the fp32 wrapper's inner norm scope
        if seg.startswith("mid_"):
            out += ["mid", seg[4:]]
        elif _FLAX_BLOCK.match(seg):
            out += list(_FLAX_BLOCK.match(seg).groups())
        elif _FLAX_RESAMPLE.match(seg):
            out += list(_FLAX_RESAMPLE.match(seg).groups())
        elif _FLAX_INDEXED.match(seg):
            out += list(_FLAX_INDEXED.match(seg).groups())
        else:
            out.append(seg)
    return ".".join(out)


def discriminator_flax_name(n_layers: int = 3):
    """Module names of the JAX NLayerDiscriminator (`conv0`, `convN`,
    `normN`, `conv_out`) in the reference's `main` Sequential."""
    def name(path: Tuple[str, ...]) -> str:
        (seg,) = path
        if seg == "conv_out":
            return f"main.{3 * n_layers + 2}"
        n = int(seg[4:])
        return f"main.{3 * n - 1 if n else 0}" if seg.startswith("conv") else f"main.{3 * n}"
    return name


def lpips_flax_name(path: Tuple[str, ...]) -> str:
    """Module names of the JAX LPIPS: `net/convJ` → `net.sliceK.J` with
    torchvision's index (the JAX package names features 2 and 7 `conv3`
    and `conv8`), `linI` → `linI.model.1`."""
    from .models.lpips import _slice_of

    if path[0] == "net":
        idx = {3: 2, 8: 7}.get(int(path[1][4:]), int(path[1][4:]))
        return f"net.slice{_slice_of(idx)}.{idx}"
    return f"{path[0]}.model.1"


def _flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten_tree(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def load_flax_tree(module: nn.Module, variables: Mapping, name_of=flax_module_name) -> None:
    """Fill every parameter and buffer of `module` from a flax variable tree
    of numpy arrays: `{"params": ..., "batch_stats": ...}` or a bare params
    tree. `name_of` maps a flax module path to the port's dotted module
    name; leaves are renamed by `_FLAX_LEAVES` unless the module has a leaf
    of the flax name, kernels go from HWIO / DHWIO / (in, out) to torch's
    OIHW / OIDHW / (out, in), and a value takes the parameter's shape (an
    ActNorm's (C,) → (1, C, 1, 1)). Raises KeyError on a flax leaf with no
    place in the module or a state-dict entry that no leaf fills (BatchNorm's
    `num_batches_tracked` excepted)."""
    collections = ([variables[c] for c in ("params", "batch_stats") if c in variables]
                   if "params" in variables else [variables])
    own = module.state_dict()
    filled: Dict[str, torch.Tensor] = {}
    for tree in collections:
        for path, value in _flatten_tree(tree):
            prefix = name_of(path[:-1]) if len(path) > 1 else ""
            leaf = path[-1]
            base = f"{prefix}." if prefix else ""
            key = base + leaf if base + leaf in own else base + _FLAX_LEAVES.get(leaf, leaf)
            if key not in own:
                raise KeyError(f"flax leaf {'/'.join(path)} has no place in the module "
                               f"(looked for {key!r})")
            v = np.asarray(value)
            if leaf.endswith("kernel") and v.ndim in (2, 4, 5):
                v = v.transpose({2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[v.ndim])
            ref = own[key]
            filled[key] = torch.from_numpy(np.array(v, dtype=v.dtype)).reshape(ref.shape).to(
                dtype=ref.dtype, device=ref.device)
    missing = [k for k in own if k not in filled and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"no flax leaf for {missing[:10]} ({len(missing)} entries)")
    module.load_state_dict({**own, **filled}, strict=True)
