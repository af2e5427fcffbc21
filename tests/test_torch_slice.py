"""Stage-1 slice parity: hi3d_tpu_torch against hi3d_tpu end to end, on CPU.

Both packages build the same tiny stage-1 config (the layout of
tests/test_pipeline_i2v.py: 32-channel two-level VideoUNet, f=8 VAE, toy
image embedder on both sides), share one set of weights (the JAX engine's
export, with its zero-initialised leaves randomised so every layer matters;
the conditioner's own VAE encoder is carried across too), and run
`generate_orbit` with the same frames, the same initial noise and the same
pinned cond_frames/cond_aug. Everything is fp32.

Tolerance: the two packages sum in different orders (XLA vs ATen), and the
port's GroupNorm uses one-pass moments where flax uses two-pass. Latents sit
at σ_max = 700 scale through the first steps, so fp32 rounding there is
~1e-4 absolute; after the VAE decode the frames agree to 2e-3 absolute.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from hi3d_tpu.conditioners import AbstractEmbedder as JaxEmbedder
from hi3d_tpu_torch.conditioners import AbstractEmbedder as TorchEmbedder

T, RES, CTX = 4, 64, 32
ATOL = 2e-3


class TinyImageEmbedderJax(JaxEmbedder):
    """crossattn stand-in for the CLIP tower: channel means, tiled (NHWC)."""

    def __call__(self, image, rng=None):
        feats = jnp.mean(image, axis=(1, 2))
        return jnp.tile(feats, (1, CTX // 3 + 1))[:, :CTX][:, None, :]


class TinyImageEmbedderTorch(TorchEmbedder):
    """The same stand-in on NCHW frames."""

    def forward(self, image):
        feats = image.mean(dim=(2, 3))
        return feats.repeat(1, CTX // 3 + 1)[:, :CTX][:, None, :]


VAE_DD = {
    "double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
    "ch": 8, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1,
    "attn_resolutions": [], "resolution": RES,
}


def tiny_config(embedder_target, num_steps=3):
    return {
        "target": "vtdm.vtdm_gen_v01.VideoLDM",
        "params": {
            "input_key": "video",
            "num_samples": T,
            "scale_factor": 0.18215,
            "en_and_decode_n_samples_a_time": 2,
            "network_config": {
                "target": "sgm.modules.diffusionmodules.video_model.VideoUNet",
                "params": {
                    "in_channels": 8, "out_channels": 4, "model_channels": 32,
                    "num_res_blocks": 1, "channel_mult": [1, 2],
                    "attention_resolutions": [1, 2], "num_head_channels": 16,
                    "transformer_depth": 1, "context_dim": CTX,
                    "num_classes": "sequential", "adm_in_channels": 32,
                    "use_linear_in_transformer": True,
                    "extra_ff_mix_layer": True, "use_spatial_context": True,
                    "merge_strategy": "learned_with_images",
                    "video_kernel_size": [3, 1, 1],
                },
            },
            "denoiser_config": {
                "target": "sgm.modules.diffusionmodules.denoiser.Denoiser",
                "params": {"scaling_config": {
                    "target": "sgm.modules.diffusionmodules.denoiser_scaling.VScalingWithEDMcNoise"
                }},
            },
            "sampler_config": {
                "target": "sgm.modules.diffusionmodules.sampling.EulerEDMSampler",
                "params": {
                    "num_steps": num_steps,
                    "discretization_config": {
                        "target": "sgm.modules.diffusionmodules.discretizer.EDMDiscretization",
                        "params": {"sigma_max": 700.0},
                    },
                    "guider_config": {
                        "target": "sgm.modules.diffusionmodules.guiders.LinearPredictionGuider",
                        "params": {"num_frames": T, "max_scale": 2.5},
                    },
                },
            },
            "conditioner_config": {
                "target": "sgm.modules.GeneralConditioner",
                "params": {"emb_models": [
                    {"target": embedder_target,
                     "input_key": "cond_frames_without_noise", "is_trainable": False},
                    {"target": "sgm.modules.encoders.modules.ConcatTimestepEmbedderND",
                     "input_key": "elevation", "is_trainable": False,
                     "params": {"outdim": 16}},
                    {"target": "sgm.modules.encoders.modules.VideoPredictionEmbedderWithEncoder",
                     "input_key": "cond_frames", "is_trainable": False,
                     "params": {
                         "n_cond_frames": 1, "n_copies": T, "is_ae": True,
                         "encoder_config": {
                             "target": "sgm.models.autoencoder.AutoencoderKLModeOnly",
                             "params": {"embed_dim": 4, "ddconfig": VAE_DD},
                         },
                     }},
                    {"target": "sgm.modules.encoders.modules.ConcatTimestepEmbedderND",
                     "input_key": "cond_aug", "is_trainable": False,
                     "params": {"outdim": 16}},
                ]},
            },
            "first_stage_config": {
                "target": "sgm.models.autoencoder.AutoencoderKL",
                "params": {"embed_dim": 4, "ddconfig": VAE_DD},
            },
        },
    }


def _randomize_zeros(sd, seed):
    """Give every all-zero leaf (zero-init convs/projections, biases) random
    values so no layer of the comparison is trivially zero."""
    rnd = np.random.RandomState(seed)
    return {k: (0.05 * rnd.randn(*v.shape)).astype(np.float32) if not np.any(v) else v
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def models():
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu.convert.jax_to_torch import (
        _export_tree,
        export_engine_state_dict,
        vae_path_to_torch,
    )
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_vae_key, load_engine_params
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.convert import load_reference_state_dict

    jm = jax_instantiate(tiny_config("test_torch_slice.TinyImageEmbedderJax"))
    jm.init(latent_hw=(RES // 8, RES // 8), num_frames=2)
    sd = _randomize_zeros(export_engine_state_dict(jm), 0)
    load_engine_params(jm, sd)
    jenc = jm.conditioner.embedders[2].encoder
    enc_sd = _randomize_zeros(_export_tree(jenc.params, vae_path_to_torch, ""), 1)
    jenc.params = convert_state_dict(enc_sd, convert_vae_key)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = instantiate_from_config(tiny_config("test_torch_slice.TinyImageEmbedderTorch"))
    tm.init_from_ckpt(sd)
    load_reference_state_dict(tm.conditioner.embedders[2].encoder, enc_sd)
    return jm, tm


def test_generate_orbit_matches_jax(models):
    from hi3d_tpu.pipelines.i2v import generate_orbit as jax_generate_orbit
    from hi3d_tpu_torch.pipelines.i2v import generate_orbit

    jm, tm = models
    rnd = np.random.RandomState(3)
    frames = rnd.rand(T, RES, RES, 3).astype(np.float32) * 2.0 - 1.0
    noise = rnd.randn(T, RES // 8, RES // 8, 4).astype(np.float32)
    cond_frames = (frames[:1] + 0.02 * rnd.randn(1, RES, RES, 3)).astype(np.float32)
    aug = np.array([0.02], np.float32)

    ref = jax_generate_orbit(
        jm, frames, elevation=10.0, rng=jax.random.PRNGKey(0), randn=jnp.asarray(noise),
        batch_overrides={"cond_frames": jnp.asarray(cond_frames), "cond_aug": jnp.asarray(aug)},
    )
    out = generate_orbit(
        tm, frames, elevation=10.0, randn=noise,
        batch_overrides={"cond_frames": torch.from_numpy(cond_frames).permute(0, 3, 1, 2),
                         "cond_aug": torch.from_numpy(aug)},
    )
    assert out.shape == ref.shape == (T, RES, RES, 3)
    assert np.all(np.isfinite(out))
    assert np.abs(ref).max() > 0.05  # the comparison is not between two blank videos
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_sample_latents_match_jax(models):
    """engine.sample alone, with the (T, h, w, 4) noise and hand-made cond."""
    jm, tm = models
    rnd = np.random.RandomState(4)
    noise = rnd.randn(T, RES // 8, RES // 8, 4).astype(np.float32)
    vec = rnd.randn(1, 32).astype(np.float32)
    ctx = rnd.randn(1, 1, CTX).astype(np.float32)
    concat = rnd.randn(T, RES // 8, RES // 8, 4).astype(np.float32)
    jc = {"vector": jnp.asarray(vec), "crossattn": jnp.asarray(ctx), "concat": jnp.asarray(concat)}
    juc = {k: jnp.zeros_like(v) if k != "vector" else v for k, v in jc.items()}
    ref = np.asarray(jm.sample(jc, juc, num_video_frames=T, randn=jnp.asarray(noise)))
    tc = {"vector": torch.from_numpy(vec), "crossattn": torch.from_numpy(ctx),
          "concat": torch.from_numpy(concat).permute(0, 3, 1, 2)}
    tuc = {k: torch.zeros_like(v) if k != "vector" else v for k, v in tc.items()}
    out = tm.sample(tc, tuc, num_video_frames=T, randn=noise).numpy()
    assert out.shape == (T, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(out, ref, atol=5e-3 * np.abs(ref).max(), rtol=0)


def test_first_stage_encode_decode_match_jax(models):
    """Chunked (2 frames a call) VAE encode and decode, channels-last at the
    engine boundary as in the JAX package."""
    jm, tm = models
    x = np.random.RandomState(5).rand(3, RES, RES, 3).astype(np.float32) * 2 - 1
    z_ref = np.asarray(jm.encode_first_stage(jnp.asarray(x)))
    z = tm.encode_first_stage(torch.from_numpy(x)).numpy()
    assert z.shape == (3, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(z, z_ref, atol=1e-4, rtol=0)
    dec_ref = np.asarray(jm.decode_first_stage(jnp.asarray(z_ref)))
    dec = tm.decode_first_stage(torch.tensor(z_ref)).numpy()
    np.testing.assert_allclose(dec, dec_ref, atol=1e-4, rtol=0)


def test_cli_writes_png_frames(tmp_path):
    """The port's CLI on CPU at 64²: random weights, the repository config
    cut to the demo image, PNG frames written with the stdlib codec."""
    from hi3d_tpu_torch.utils.png import read_png

    out_dir = tmp_path / "out"
    cfg = tmp_path / "tiny.yaml"
    import yaml

    tiny = tiny_config("test_torch_slice.TinyImageEmbedderTorch", num_steps=2)
    cfg.write_text(yaml.safe_dump({"model": tiny}))
    code = (
        "import sys; sys.path.insert(0, 'tests');"
        "from hi3d_tpu_torch.pipelines.i2v import main;"
        f"main(['--denoise_config', {str(cfg)!r}, '--image_path', 'demo/3.png',"
        f" '--output_dir', {str(out_dir)!r}, '--device', 'cpu', '--skip_rembg',"
        f" '--resolution', '64', '64', '--clip_size', '{T}', '--seed', '1'])"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[i2v] phases" in res.stdout
    frame_dir = out_dir / "first_step" / "frames"
    names = sorted(os.listdir(frame_dir))
    assert names == [f"{i:03d}.png" for i in range(8)]  # T frames padded to 1 s at fps 8
    frames = np.stack([read_png(str(frame_dir / n)) for n in names])
    assert frames.shape == (8, 64, 64, 3) and frames.dtype == np.uint8
    assert (frames[T:] == frames[T - 1]).all()


def test_cli_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    from hi3d_tpu_torch.pipelines.i2v import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--image_path", "demo/3.png", "--skip_rembg", "--device", "cuda"])


def test_import_hygiene_blocks_jax():
    """Every hi3d_tpu_torch module imports with jax and hi3d_tpu blocked, and
    every `target` of the stage-1 training config and of the stage-2
    inference config resolves to a port class."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hi3d_tpu'] = None\n"
        "import hi3d_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hi3d_tpu_torch.__path__, 'hi3d_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from hi3d_tpu_torch.config import get_obj_from_str, load_config\n"
        "def targets(node):\n"
        "    if isinstance(node, dict):\n"
        "        yield from ([node['target']] if 'target' in node else [])\n"
        "        for v in node.values(): yield from targets(v)\n"
        "    elif isinstance(node, list):\n"
        "        for v in node: yield from targets(v)\n"
        "for cfg in ('configs/train-v01.yaml', 'configs/inference-v02.yaml'):\n"
        "    found = list(targets(load_config(cfg)))\n"
        "    assert len(found) > 15 and all(get_obj_from_str(t).__module__.startswith("
        "'hi3d_tpu_torch.') for t in found)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'hi3d_tpu.')) for k in sys.modules"
        " if sys.modules[k] is not None)\n"
        "print(' '.join(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(res.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 25
    training = {"train", "data", "data.video_dataset", "diffusion.loss",
                "diffusion.sigma_sampling", "diffusion.weighting", "training", "training.ema",
                "training.schedules", "training.state", "training.step", "training.trainer"}
    assert {f"hi3d_tpu_torch.{n}" for n in training} <= names
    stage2 = {"ops.layer_norm", "models.dpt", "pipelines.v2v"}
    assert {f"hi3d_tpu_torch.{n}" for n in stage2} <= names
    serving = {"pipelines.serve", "pipelines.common", "ops.temporal_attention", "ops.attention"}
    assert {f"hi3d_tpu_torch.{n}" for n in serving} <= names
