"""hi3d_tpu_torch.tools.verify_weights, the port's checkpoint-coverage tool,
on seeded state dicts saved in the reference layouts (the released files are
not in the repository): a DeepSpeed `{"module": {"module.…"}}` stage-1
engine `.pt`, a `.safetensors` SVD initialisation written by
`convert.save_safetensors`, the OpenCLIP `.bin` and the TorchScript CLIP
archive (vision tower under `visual.`, beside text-tower keys), the aesthetic
MLP, MiDaS's `{"model", "optimizer"}` DPT file and a u2netp `.pth`. The
engine is the tiny stage-1 engine of tests/test_torch_slice.py, the towers
small ones (`verify(towers=...)`), the aesthetic MLP and u2netp at their
real size."""

import os
import subprocess
import sys

import pytest
import torch

import torch_threads  # noqa: F401
import torch.nn as nn
import yaml

from test_torch_slice import tiny_config

TOWERS = {
    "clip_h": lambda: _clip(32), "clip_l": lambda: _clip(24),
    "dpt": lambda: _dpt(),
}


def _clip(width):
    from hi3d_tpu_torch.models.clip import CLIPVisionTransformer

    return CLIPVisionTransformer(width=width, layers=2, heads=2, patch_size=14, output_dim=16)


def _dpt():
    from hi3d_tpu_torch.models.dpt import DPTDepthModel

    return DPTDepthModel(features=16, vit_width=32, vit_layers=2, vit_heads=2, hooks=[0, 1],
                         pos_grid=4)


def _script_archive(sd, path):
    """A TorchScript archive whose state dict is `sd` (the layout of the
    released ViT-L-14.pt, read with torch.jit.load)."""
    root = nn.Module()
    for name, t in sd.items():
        *parts, leaf = name.split(".")
        m = root
        for part in parts:
            if part not in m._modules:
                m.add_module(part, nn.Module())
            m = m._modules[part]
        m.register_parameter(leaf, nn.Parameter(t.clone(), requires_grad=False))
    torch.jit.save(torch.jit.script(root), path)


def _seeded(module, seed):
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for t in module.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g))
    return module.state_dict()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """`<tmp>/ckpts` with every artifact but second_stage.pt, u2net.pth and
    the vid2vid initialisation, and the tiny stage-1 config."""
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.convert import export_engine_state_dict, save_safetensors
    from hi3d_tpu_torch.models.clip import AestheticMLP
    from hi3d_tpu_torch.models.u2net import U2Net

    root = tmp_path_factory.mktemp("verify")
    d = root / "ckpts"
    (d / "metric_models").mkdir(parents=True)
    cfg = tiny_config("test_torch_slice.TinyImageEmbedderTorch")
    stage1 = root / "tiny-v01.yaml"
    stage1.write_text(yaml.safe_dump({"model": cfg}))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        engine = instantiate_from_config(cfg)
        torch.save({"module": {f"module.{k}": v for k, v in engine.state_dict().items()}},
                   d / "first_stage.pt")
        save_safetensors(export_engine_state_dict(engine),
                         str(d / "svd_xt_image_decoder.safetensors"))
        text = {"transformer.resblocks.0.attn.in_proj_weight": torch.randn(8, 8),
                "token_embedding.weight": torch.randn(4, 8)}
        torch.save({**{f"visual.{k}": v for k, v in _seeded(_clip(32), 1).items()}, **text},
                   d / "open_clip_pytorch_model.bin")
        _script_archive({**{f"visual.{k}": v for k, v in _seeded(_clip(24), 2).items()}, **text},
                        str(d / "ViT-L-14.pt"))
        torch.save(_seeded(AestheticMLP(), 3),
                   d / "metric_models" / "sac+logos+ava1-l14-linearMSE.pth")
        dpt = dict(_seeded(_dpt(), 4))
        dpt["pretrained.model.head.weight"] = torch.randn(10, 32)  # MiDaS's classifier, dropped
        torch.save({"model": dpt, "optimizer": {}}, d / "dpt_hybrid_384.pt")
        torch.save(_seeded(U2Net(full=False), 5), d / "u2netp.pth")
    return {"dir": str(d), "stage1": str(stage1)}


def test_seeded_reference_files_pass(ckpts):
    from hi3d_tpu_torch.tools.verify_weights import verify

    results = {name: (status, detail) for name, status, detail in
               verify(ckpts["dir"], stage1_cfg=ckpts["stage1"], towers=TOWERS)}
    skipped = {n for n, (s, _) in results.items() if s == "SKIP"}
    assert skipped == {"stage2 engine (second_stage.pt)", "U2Net background removal (u2net.pth)",
                       "training init (svd_xt_image_decoder_vid2vid.safetensors)"}
    passed = {n: d for n, (s, d) in results.items() if s == "PASS"}
    assert len(passed) == len(results) - 3, results
    for name, detail in passed.items():
        assert "0 missing, 0 unexpected" in detail and "MISMATCH" not in detail, (name, detail)
    engine = passed["stage1 engine (first_stage.pt)"]
    assert engine.count("0 missing, 0 unexpected") == 3, engine  # UNet, VAE, the VAE embedder
    assert engine.startswith("unet: ") and "; vae: " in engine and "embedder 2: " in engine
    svd = passed["training init (svd_xt_image_decoder.safetensors)"]
    assert svd.startswith("unet: ") and "; vae: " in svd and "embedder" not in svd


def _rewrite(path, edit):
    sd = torch.load(path, weights_only=True)
    edit(sd)
    torch.save(sd, path)


def test_missing_key_and_shape_mismatch_fail(ckpts, tmp_path):
    import shutil

    from hi3d_tpu_torch.tools.verify_weights import verify

    d = tmp_path / "ckpts"
    shutil.copytree(ckpts["dir"], d)

    def drop_unet_key(sd):
        del sd["module"]["module.model.diffusion_model.out.2.bias"]

    def reshape(sd):
        sd["layers.2.weight"] = sd["layers.2.weight"][:, :-1]

    _rewrite(d / "first_stage.pt", drop_unet_key)
    _rewrite(d / "metric_models" / "sac+logos+ava1-l14-linearMSE.pth", reshape)
    results = {name: (status, detail) for name, status, detail in
               verify(str(d), stage1_cfg=ckpts["stage1"], towers=TOWERS)}
    status, detail = results["stage1 engine (first_stage.pt)"]
    assert status == "FAIL" and "unet: " in detail and ", 1 missing, 0 unexpected" in detail
    assert "out.2.bias" in detail
    status, detail = results["aesthetic MLP (sac+logos+ava1)"]
    assert status == "FAIL" and "1 SHAPE MISMATCHES e.g. ['layers.2.weight']" in detail
    others = {n: s for n, (s, _) in results.items()
              if n not in ("stage1 engine (first_stage.pt)", "aesthetic MLP (sac+logos+ava1)")}
    assert set(others.values()) == {"PASS", "SKIP"}


def test_empty_ckpt_dir_skips_everything_without_jax(tmp_path):
    """Every row SKIPs on an empty ckpts/ (as tests/test_verify_weights.py
    asserts of the JAX harness), through the CLI in a process where jax,
    flax and the JAX package cannot be imported."""
    (tmp_path / "ckpts").mkdir()
    code = ("import sys; sys.modules.update({m: None for m in ('jax', 'flax', 'hi3d_tpu')}); "
            "from hi3d_tpu_torch.tools.verify_weights import main; "
            f"sys.exit(main(['--ckpt_dir', {str(tmp_path / 'ckpts')!r}, '--smoke']))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    rows = [line for line in out.stdout.splitlines() if " SKIP " in line]
    assert len(rows) == 11 and "0 passed, 0 failed, 11 skipped" in out.stdout
