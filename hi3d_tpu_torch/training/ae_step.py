"""Autoencoder GAN training: the two-optimizer loop (counterpart of
hi3d_tpu/training/ae_step.py).

`AutoencoderTrainer` trains an `AutoencodingEngine` against a
`GeneralLPIPSWithDiscriminator`, as sgm's autoencoder alternates its two
optimizers: even batches are the generator pass (encoder, decoder and
logvar, with the adaptive GAN weight at the decoder's `conv_out`), odd
batches the discriminator pass on the detached reconstruction. Both
optimizers are Adam with β = (0.5, 0.9), eps 1e-8 and no weight decay, as
the JAX package's `optax.adam`; logvar's gradient is zeroed unless the loss
has `learn_logvar`. One step counter counts both passes.

The decoder is called without `timesteps`, as in the JAX package, so the
2-D `vae.Decoder` trains here and a `temporal_ae.VideoDecoder` does not.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import instantiate_from_config


class AutoencoderTrainer:
    """Moves the engine and the loss to `device` and trains them in place."""

    def __init__(self, engine, loss, lr: float = 4.5e-6, disc_lr: Optional[float] = None,
                 b1: float = 0.5, b2: float = 0.9, device: str = "cuda"):
        self.engine = engine.to(device)
        self.loss = (instantiate_from_config(loss) if isinstance(loss, dict) else loss).to(device)
        self.device = torch.device(device)
        self.ae_params = [*self.engine.encoder.parameters(), *self.engine.decoder.parameters(),
                          self.loss.logvar]
        self.opt_ae = torch.optim.Adam(self.ae_params, lr=lr, betas=(b1, b2), eps=1e-8)
        self.disc_params = list(self.loss.discriminator.parameters())
        self.opt_disc = torch.optim.Adam(self.disc_params, lr=disc_lr or lr, betas=(b1, b2),
                                         eps=1e-8)
        self.global_step = 0

    def last_layer(self):
        """The decoder's conv_out parameters, the adaptive weight's layer."""
        return list(self.engine.decoder.conv_out.parameters())

    def _reconstruct(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        z, reg_log = self.engine.regularization(self.engine.encoder(x), generator)
        return self.engine.decoder(z), reg_log

    def generator_step(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, Dict]:
        """optimizer_idx 0: one Adam step of the encoder, the decoder and
        logvar on the generator loss, its adaptive weight at the decoder's
        conv_out."""
        rec, reg_log = self._reconstruct(x, generator)
        loss, log = self.loss.generator_loss(x, rec, regularization_log=reg_log,
                                             global_step=self.global_step, train=True,
                                             last_layer=self.last_layer())
        self.opt_ae.zero_grad(set_to_none=True)
        loss.backward(inputs=self.ae_params)
        if not self.loss.learn_logvar:
            self.loss.logvar.grad.zero_()
        self.opt_ae.step()
        self.global_step += 1
        return loss.detach(), log

    def discriminator_step(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, Dict]:
        """optimizer_idx 1: one Adam step of the discriminator on the real x
        and its reconstruction, which carries no gradient."""
        with torch.no_grad():
            rec, _ = self._reconstruct(x, generator)
        d_loss, log = self.loss.discriminator_loss(x, rec, global_step=self.global_step,
                                                   train=True)
        self.opt_disc.zero_grad(set_to_none=True)
        d_loss.backward(inputs=self.disc_params)
        self.opt_disc.step()
        self.global_step += 1
        return d_loss.detach(), log

    def train_step(self, x: torch.Tensor, batch_idx: int,
                   generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict]:
        """The generator pass on even `batch_idx`, the discriminator pass on
        odd ones; x is a (B, C, H, W) batch in [-1, 1]."""
        x = x.to(self.device)
        if batch_idx % 2 == 0:
            return self.generator_step(x, generator)
        return self.discriminator_step(x, generator)

    def sync_engine(self) -> None:
        """The JAX trainer copies its trained parameters back onto the
        engine here; this one trains the engine's own modules, which
        therefore already hold them."""
