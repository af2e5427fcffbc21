"""Target-name registry: the reference's config `target` strings → the
PyTorch classes of this package, for the targets the stage-1 configs
(`configs/inference-v01.yaml`, `configs/train-v01.yaml`) and the stage-2
configs (`configs/inference-v02.yaml`, `configs/train-v02.yaml`) name, every sampler,
guider, discretization, denoiser and scaling a config can name, and the
autoencoder surface (engine, encoder and decoders, regularizers and
quantizers, LPIPS, the discriminator and its losses). Entries are
lazy "module:attr" strings. Targets that name a JAX-package class
(`hi3d_tpu.training.schedules.*`) map to the port's counterpart, so a
config never imports the JAX package.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

_P = "hi3d_tpu_torch"

_ALIASES: Dict[str, str] = {
    # diffusion math
    **{f"sgm.modules.diffusionmodules.{mod}.{name}": f"{_P}.diffusion.{port}:{name}"
       for mod, port, names in (
           ("denoiser", "denoiser", ("Denoiser", "DiscreteDenoiser")),
           ("denoiser_scaling", "scaling",
            ("EDMScaling", "EpsScaling", "VScaling", "VScalingWithEDMcNoise")),
           ("discretizer", "discretization", ("EDMDiscretization", "LegacyDDPMDiscretization")),
           ("guiders", "guiders", ("VanillaCFG", "IdentityGuider", "LinearPredictionGuider")),
           ("sampling", "samplers",
            ("EulerEDMSampler", "HeunEDMSampler", "EulerAncestralSampler", "DPMPP2MSampler",
             "DPMPP2SAncestralSampler", "LinearMultistepSampler")))
       for name in names},
    # training objective
    "sgm.modules.diffusionmodules.loss.StandardDiffusionLoss": f"{_P}.diffusion.loss:StandardDiffusionLoss",
    "sgm.modules.diffusionmodules.sigma_sampling.EDMSampling": f"{_P}.diffusion.sigma_sampling:EDMSampling",
    "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling": f"{_P}.diffusion.sigma_sampling:DiscreteSampling",
    "sgm.modules.diffusionmodules.loss_weighting.UnitWeighting": f"{_P}.diffusion.weighting:UnitWeighting",
    "sgm.modules.diffusionmodules.loss_weighting.EDMWeighting": f"{_P}.diffusion.weighting:EDMWeighting",
    "sgm.modules.diffusionmodules.loss_weighting.VWeighting": f"{_P}.diffusion.weighting:VWeighting",
    "sgm.modules.diffusionmodules.loss_weighting.EpsWeighting": f"{_P}.diffusion.weighting:EpsWeighting",
    # networks
    "sgm.modules.diffusionmodules.video_model.VideoUNet": f"{_P}.models.unet:VideoUNet",
    "sgm.modules.diffusionmodules.wrappers.OpenAIWrapper": f"{_P}.models.wrappers:ConcatConditionWrapper",
    # autoencoder
    "sgm.models.autoencoder.AutoencoderKL": f"{_P}.models.vae:AutoencoderKL",
    "sgm.models.autoencoder.AutoencoderKLModeOnly": f"{_P}.models.vae:AutoencoderKLModeOnly",
    "sgm.models.autoencoder.AutoencodingEngine": f"{_P}.models.autoencoding:AutoencodingEngine",
    # as in the JAX package: the Legacy (`ddconfig`) engine resolves to the
    # same class, which refuses its config
    "sgm.models.autoencoder.AutoencodingEngineLegacy":
        f"{_P}.models.autoencoding:AutoencodingEngine",
    "sgm.modules.autoencoding.temporal_ae.VideoDecoder": f"{_P}.models.temporal_ae:VideoDecoder",
    "sgm.modules.diffusionmodules.model.Encoder": f"{_P}.models.vae:Encoder",
    "sgm.modules.diffusionmodules.model.Decoder": f"{_P}.models.vae:Decoder",
    "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer":
        f"{_P}.models.autoencoding:DiagonalGaussianRegularizer",
    **{f"sgm.modules.autoencoding.regularizers.quantize.{name}": f"{_P}.models.quantizers:{name}"
       for name in ("VectorQuantizer", "GumbelQuantizer", "EMAVectorQuantizer",
                    "VectorQuantizerWithInputProjection")},
    "sgm.modules.autoencoding.lpips.loss.lpips.LPIPS": f"{_P}.models.lpips:LPIPS",
    "sgm.modules.autoencoding.lpips.model.model.NLayerDiscriminator":
        f"{_P}.models.discriminator:NLayerDiscriminator",
    **{target: f"{_P}.models.discriminator:{target.rsplit('.', 1)[1]}"
       for target in ("sgm.modules.autoencoding.losses.GeneralLPIPSWithDiscriminator",
                      "sgm.modules.autoencoding.losses.discriminator_loss."
                      "GeneralLPIPSWithDiscriminator",
                      "sgm.modules.autoencoding.losses.LatentLPIPS",
                      "sgm.modules.autoencoding.losses.lpips.LatentLPIPS")},
    # conditioners
    "sgm.modules.GeneralConditioner": f"{_P}.conditioners:GeneralConditioner",
    "sgm.modules.encoders.modules.GeneralConditioner": f"{_P}.conditioners:GeneralConditioner",
    "sgm.modules.encoders.modules.FrozenOpenCLIPImageEmbedder": f"{_P}.conditioners:FrozenOpenCLIPImageEmbedder",
    "sgm.modules.encoders.modules.FrozenOpenCLIPImagePredictionEmbedder": f"{_P}.conditioners:FrozenOpenCLIPImagePredictionEmbedder",
    "sgm.modules.encoders.modules.ConcatTimestepEmbedderND": f"{_P}.conditioners:ConcatTimestepEmbedderND",
    "sgm.modules.encoders.modules.VideoPredictionEmbedderWithEncoder": f"{_P}.conditioners:VideoPredictionEmbedderWithEncoder",
    "vtdm.encoders.AesEmbedder": f"{_P}.conditioners:AesEmbedder",
    "vtdm.encoders.DepthEmbedder": f"{_P}.conditioners:DepthEmbedder",
    # task layer
    "vtdm.vtdm_gen_v01.VideoLDM": f"{_P}.engine:VideoLDM",
    "vtdm.vtdm_gen_stage2_degradeImage.VideoLDM": f"{_P}.engine:VideoLDMStage2",
    # data and LR schedules
    "sgm.data.video_dataset.VideoDataset": f"{_P}.data.video_dataset:VideoDataset",
    "sgm.data.video_dataset_stage2_degradeImages.VideoDataset":
        f"{_P}.data.video_dataset:VideoDatasetStage2",
    **{f"{pkg}.{name}": f"{_P}.training.schedules:{name}"
       for pkg in ("sgm.lr_scheduler", "hi3d_tpu.training.schedules")
       for name in ("LambdaLinearScheduler", "LambdaWarmUpCosineScheduler",
                    "LambdaWarmUpCosineScheduler2")},
}


def resolve(name: str) -> Optional[Any]:
    """Return the class for `name` if it is aliased or a hi3d_tpu_torch path, else None."""
    spec = _ALIASES.get(name)
    if spec is None:
        if name.startswith(f"{_P}."):
            module_name, _, attr = name.rpartition(".")
            return getattr(importlib.import_module(module_name), attr)
        return None
    module_name, _, attr = spec.partition(":")
    return getattr(importlib.import_module(module_name), attr)
