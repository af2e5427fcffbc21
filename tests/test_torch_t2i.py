"""The image-diffusion slice as a whole on the CPU: hi3d_tpu_torch/configs/
sd_2_1.yaml at tiny widths, composed as both packages can compose it —
GeneralConditioner.get_unconditional_conditioning on prompt ids and the
empty prompt's, ConcatConditionWrapper(UNetModel) under DiscreteDenoiser
(EpsScaling, LegacyDDPMDiscretization), EulerEDMSampler for 3 steps with
VanillaCFG 7.5 from pinned noise, then the AutoencoderKL decode — against
the same composition in the JAX package with the same weights.

Tolerance: relative L2 error ≤ 1e-4 of the latents and of the images (fp32
on both sides; three CFG steps at scale 7.5 amplify summation-order
differences).
"""

import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

import torch_threads  # noqa: F401
from test_torch_text_embedders import TOWER, jax_text_embedder, port_text_embedder
from test_torch_unet2d import randomize

REL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
SAMPLER = dict(
    num_steps=STEPS,
    discretization_config={
        "target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"},
    guider_config={"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG",
                   "params": {"scale": 7.5}},
)


def tiny_sd_config():
    """configs/sd_2_1.yaml's model.params with tiny widths: the UNet at 32
    channels over two levels, a 16-wide text tower (context_dim 16), an
    8-channel two-level first stage."""
    from hi3d_tpu_torch.config import load_config

    p = copy.deepcopy(load_config(os.path.join(ROOT, "hi3d_tpu_torch", "configs",
                                               "sd_2_1.yaml"))["model"]["params"])
    p["network_config"]["params"].update(model_channels=32, channel_mult=[1, 2],
                                         attention_resolutions=[1, 2], num_head_channels=16,
                                         context_dim=TOWER["width"])
    p["first_stage_config"]["params"]["ddconfig"].update(ch=8, ch_mult=[1, 2], resolution=16)
    return p


def _ids(rows):
    ids = np.zeros((len(rows), TOWER["context_length"]), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return ids


def test_sd_2_1_text_to_image_matches_jax(monkeypatch):
    from hi3d_tpu import conditioners as jcond_mod
    from hi3d_tpu.config import instantiate_from_config as jax_build
    from hi3d_tpu.convert.jax_to_torch import _export_tree, vae_path_to_torch
    from hi3d_tpu.diffusion.samplers import EulerEDMSampler as JaxSampler
    from hi3d_tpu.models.wrappers import ConcatConditionWrapper as JaxWrapper
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.convert import load_flax_unet2d, load_reference_state_dict
    from hi3d_tpu_torch.diffusion.samplers import EulerEDMSampler
    from hi3d_tpu_torch.models.wrappers import ConcatConditionWrapper

    p = tiny_sd_config()
    # conditioners from the config; the ViT-H text tower swapped for the
    # tiny one (JAX would initialise the full tower, the port builds it on
    # the meta device)
    monkeypatch.setattr(jcond_mod.FrozenOpenCLIPEmbedder, "init_params", lambda self, rng: None)
    jcond = jax_build(p["conditioner_config"])
    monkeypatch.undo()
    with torch.device("meta"):
        cond = instantiate_from_config(p["conditioner_config"])
    tiny = jax_text_embedder("openclip", layer="penultimate")
    jcond.embedders[0].module, jcond.embedders[0].params = tiny.module, tiny.params
    cond.embedders[0].model = port_text_embedder("openclip", tiny, layer="penultimate").model

    prompts = _ids([[62, 5, 9, 17, 63], [62, 40, 2, 63]])  # SOT 62, EOT 63, PAD 0
    empty = _ids([[62, 63]] * 2)
    jc, juc = jcond.get_unconditional_conditioning({"txt": prompts}, {"txt": empty})
    with torch.no_grad():
        c, uc = cond.get_unconditional_conditioning({"txt": torch.from_numpy(prompts)},
                                                    {"txt": torch.from_numpy(empty)})
    assert c["crossattn"].shape == (2, TOWER["context_length"], TOWER["width"])

    rnd = np.random.RandomState(0)
    x0 = rnd.randn(2, 8, 8, 4).astype(np.float32)
    net_cfg = p["network_config"]
    jm = jax_build(net_cfg)
    jparams = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x0),
                                       jnp.ones((2,)), context=jc["crossattn"]), 1)
    unet = instantiate_from_config(net_cfg)
    load_flax_unet2d(unet, jax.tree_util.tree_map(np.asarray, jparams))
    jden, den = jax_build(p["denoiser_config"]), instantiate_from_config(p["denoiser_config"])
    jnet, net = JaxWrapper(jm).bind(jparams), ConcatConditionWrapper(unet)

    ref = JaxSampler(**SAMPLER)(lambda x, s, cc: jden(jnet, x, s, cc), jnp.asarray(x0), jc,
                                uc=juc)
    with torch.no_grad():
        out = EulerEDMSampler(**SAMPLER)(
            lambda x, s, cc: den(net, x, s, cc),
            torch.from_numpy(np.ascontiguousarray(x0.transpose(0, 3, 1, 2))), c, uc=uc)
    out_nhwc = out.numpy().transpose(0, 2, 3, 1)
    assert np.isfinite(out_nhwc).all()
    err = np.linalg.norm(out_nhwc - np.asarray(ref)) / np.linalg.norm(np.asarray(ref))
    assert err <= REL

    fs = p["first_stage_config"]
    jvae = jax_build(fs)
    jvae.init(jax.random.PRNGKey(2), image_hw=(16, 16))
    jvae.params = randomize(jvae.params, 3)
    vae = instantiate_from_config(fs)
    load_reference_state_dict(vae, _export_tree(jvae.params, vae_path_to_torch,
                                                "first_stage_model."), "first_stage_model.")
    scale = p["scale_factor"]
    jimg = np.asarray(jvae.decode(jnp.asarray(ref) / scale))
    with torch.no_grad():
        img = vae.decode(out / scale).numpy().transpose(0, 2, 3, 1)
    assert img.shape == jimg.shape == (2, 16, 16, 3)
    assert np.linalg.norm(img - jimg) / np.linalg.norm(jimg) <= REL
