"""The config-generic autoencoder (counterpart of hi3d_tpu/models/autoencoding.py).

`AutoencodingEngine` composes an encoder, a regularizer and a decoder from
configs (sgm's `AutoencodingEngine`: SVD's first stage names
`vae.Encoder`, `DiagonalGaussianRegularizer` and `temporal_ae.VideoDecoder`),
with `max_batch_size` chunking of both passes. Its GAN training lives in
`training.ae_step.AutoencoderTrainer`; its `loss_config`, `optimizer_config`
and `lr_g_factor` are not read here, as in the JAX package. Latents and
images are NCHW.

A regularizer is called as `regularizer(z, generator)` and returns
`(z, log)`: `IdentityRegularizer` passes z through; the Gaussian one draws
mean + std·ε from `generator` when it samples and has one, else returns the
mean, and logs the batch mean of the KL to N(0, I); the quantizers are in
`quantizers.py`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..config import instantiate_from_config
from .vae import DiagonalGaussianDistribution

# SVD's first stage (Encoder, DiagonalGaussianRegularizer, a conv-only
# temporal VideoDecoder), as its published config names it
SVD_FIRST_STAGE_CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                                      "svd_first_stage.yaml")


class IdentityRegularizer(nn.Module):
    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None):
        return z, {}


class DiagonalGaussianRegularizer(nn.Module):
    def __init__(self, sample: bool = True):
        super().__init__()
        self.sample = sample

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None):
        posterior = DiagonalGaussianDistribution(z)
        if self.sample and generator is not None:
            out = posterior.sample(generator)
        else:
            out = posterior.mode()
        return out, {"kl_loss": posterior.kl().mean()}


class AutoencodingEngine(nn.Module):
    """encoder → regularizer → decoder, each pass in chunks of at most
    `max_batch_size` frames. `ckpt_path` loads `encoder.*` and `decoder.*`
    (under `first_stage_model.` in an engine file) with strict=True."""

    def __init__(self, encoder_config: Optional[Dict] = None,
                 decoder_config: Optional[Dict] = None,
                 regularizer_config: Optional[Dict] = None,
                 ckpt_path: Optional[str] = None,
                 max_batch_size: Optional[int] = None,
                 **_unused):
        super().__init__()
        if encoder_config is None or decoder_config is None:
            # sgm's AutoencodingEngineLegacy (a `ddconfig`) resolves here, as
            # in the JAX package, which fails on it too
            raise TypeError("AutoencodingEngine needs encoder_config and decoder_config; a "
                            "`ddconfig` (AutoencodingEngineLegacy) config is not supported "
                            f"(other keys: {sorted(_unused)})")
        self.encoder = instantiate_from_config(encoder_config)
        self.decoder = instantiate_from_config(decoder_config)
        self.regularization = (instantiate_from_config(regularizer_config)
                               if regularizer_config else IdentityRegularizer())
        self.max_batch_size = max_batch_size
        if ckpt_path is not None:
            from ..convert import load_checkpoint_file, load_reference_state_dict

            sd = load_checkpoint_file(ckpt_path)
            prefix = "first_stage_model."
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)} or sd
            load_reference_state_dict(self.encoder, sd, "encoder.")
            load_reference_state_dict(self.decoder, sd, "decoder.")

    def _chunked(self, fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        n = self.max_batch_size or x.shape[0]
        if n >= x.shape[0]:
            return fn(x)
        return torch.cat([fn(x[i:i + n]) for i in range(0, x.shape[0], n)], dim=0)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               return_reg_log: bool = False):
        """Latents of (N, C, H, W) images; with `return_reg_log`, (z, the
        regularizer's log over the whole batch). The encoder runs once; the
        JAX package encodes a second time for the log, which gives the
        same numbers."""
        z, log = self.regularization(self._chunked(self.encoder, x), generator)
        return (z, log) if return_reg_log else z

    def decode(self, z: torch.Tensor, **kwargs) -> torch.Tensor:
        return self._chunked(lambda v: self.decoder(v, **kwargs), z)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(reconstruction, z)."""
        z = self.encode(x, generator)
        return self.decode(z), z
