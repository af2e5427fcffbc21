"""The kernel library's name and entry points, and the model factory's
device, on the CPU.

`build.library_path()` names the library by a hash of every file under
`csrc/`, so an edit of a header the kernels include (`hopper.cuh`) rebuilds
as an edit of a `.cu` does. Every `extern "C"` entry point of `csrc/*.cu`
has its argtypes in `build.SIGNATURES`, one ctypes type per parameter, or
ctypes would cut its pointers to 32 bits. `create_model` builds on the card
unless the caller asks for the CPU, and says so clearly where there is no
card.
"""

import ctypes
import re
import shutil

import pytest
import torch

import torch_threads  # noqa: F401
import yaml

from hi3d_tpu_torch.ops import build
from hi3d_tpu_torch.pipelines import common


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", ["hopper.cuh", "flash_attention.cu"])
def test_library_path_follows_every_source(csrc_copy, name):
    before = build.library_path()
    assert build.library_path() == before  # a pure function of the files
    path = csrc_copy / name
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert build.library_path() != before


def test_library_path_follows_a_new_header(csrc_copy):
    before = build.library_path()
    (csrc_copy / "extra.h").write_text("#pragma once\n")
    assert build.library_path() != before


def _ctype(param: str):
    """The ctypes type a C parameter declaration needs."""
    if "*" in param:
        return ctypes.POINTER(ctypes.c_longlong) if "long long" in param else ctypes.c_void_p
    if "long long" in param:
        return ctypes.c_longlong
    if "float" in param:
        return ctypes.c_float
    assert re.match(r"\s*int\s+\w+\s*$", param), param
    return ctypes.c_int


def test_every_entry_point_has_argtypes():
    """Each `extern "C"` function of csrc/*.cu is in the table with the
    ctypes type of each of its parameters, and the table names no other."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            found[name] = [_ctype(p) for p in params.split(",")]
    assert "hi3d_layer_norm" in found and "hi3d_group_stats" in found
    assert set(found) == set(build.SIGNATURES)
    for name, types in found.items():
        assert list(build.SIGNATURES[name]) == types, name


def _tiny_unet_config(tmp_path):
    cfg = {"model": {
        "target": "sgm.modules.diffusionmodules.video_model.VideoUNet",
        "params": {
            "in_channels": 8, "out_channels": 4, "model_channels": 32,
            "num_res_blocks": 1, "channel_mult": [1, 2],
            "attention_resolutions": [1, 2], "num_head_channels": 16,
            "transformer_depth": 1, "context_dim": 32,
            "num_classes": "sequential", "adm_in_channels": 32,
            "use_linear_in_transformer": True, "extra_ff_mix_layer": True,
            "use_spatial_context": True, "merge_strategy": "learned_with_images",
            "video_kernel_size": [3, 1, 1],
        },
    }}
    path = tmp_path / "tiny_unet.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_create_model_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.create_model(_tiny_unet_config(tmp_path))


def test_create_model_on_the_cpu_when_asked(tmp_path):
    model, cfg = common.create_model(_tiny_unet_config(tmp_path), device="cpu", seed=3)
    params = list(model.parameters())
    assert params and all(p.device.type == "cpu" for p in params)
    assert cfg["model"]["params"]["model_channels"] == 32
    again, _ = common.create_model(_tiny_unet_config(tmp_path), device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(params, again.parameters()))
