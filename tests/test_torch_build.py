"""The kernel library's name and the model factory's device, on the CPU.

`build.library_path()` names the library by a hash of every file under
`csrc/`, so an edit of a header the kernels include (`hopper.cuh`) rebuilds
as an edit of a `.cu` does. `create_model` builds on the card unless the
caller asks for the CPU, and says so clearly where there is no card.
"""

import shutil

import pytest
import torch
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
