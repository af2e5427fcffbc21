"""PatchGAN discriminator and the autoencoder GAN losses (counterpart of
hi3d_tpu/models/discriminator.py).

- `hinge_d_loss`, `vanilla_d_loss`.
- `ActNorm`: a per-channel affine scale·(x + loc), initialised to 0 and 1
  as in the JAX package (the reference initialises it from the first batch).
- `NLayerDiscriminator`: Pix2Pix's PatchGAN on NCHW images, its layers in
  the reference's `main` Sequential (4×4 convs, LeakyReLU 0.2, BatchNorm or
  ActNorm, a one-channel logit map), `weights_init` (convs N(0, 0.02),
  BatchNorm γ ~ N(1, 0.02), β = 0). Its BatchNorms follow flax's
  `BatchNorm(momentum=0.9, epsilon=1e-5)`: batch statistics in training,
  running averages updated with momentum 0.1 from the *biased* batch
  variance (torch's BatchNorm2d would use the unbiased one), and a mode
  that normalises with the batch statistics without updating them (the
  JAX package's generator pass, which discards the mutated statistics).
- `GeneralLPIPSWithDiscriminator`: the L1 + LPIPS reconstruction NLL over a
  logvar (learned or frozen), the adaptive weight of the generator's GAN
  term, `disc_start` gating and `regularization_weights`; `dims=3` folds
  (B, T, C, H, W) videos into frames. The generator pass takes the
  decoder's last layer and computes the adaptive weight with
  `torch.autograd.grad` on the graph the loss already built.
- `LatentLPIPS`: latent L2 plus the LPIPS of the decoded latents.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import instantiate_from_config
from .lpips import LPIPS

STATS_MODES = ("train", "batch", "eval")


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


class ActNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, num_features, 1, 1))

    def forward(self, x: torch.Tensor, stats: str = "eval") -> torch.Tensor:
        return self.scale * (x + self.loc)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d (reference names and buffers) computed as flax's
    BatchNorm: `stats` "train" normalises with the batch's statistics and
    updates the running ones (biased variance, momentum 0.1 = flax's 0.9),
    "batch" normalises with the batch's and updates nothing, "eval" uses the
    running ones. Statistics are fp32, or fp64 for fp64 inputs."""

    def forward(self, x: torch.Tensor, stats: str = "eval") -> torch.Tensor:
        if stats == "eval":
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
            if stats == "train":
                with torch.no_grad():
                    self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                    self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
                    self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    """PatchGAN: conv(4, s2) → LeakyReLU, (n_layers − 1) × [conv(4, s2) →
    norm → LeakyReLU], conv(4, s1) → norm → LeakyReLU, conv(4, s1) to one
    channel. `forward(x, stats)` runs its norms in `stats` mode
    (STATS_MODES; BatchNorm only)."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        norm = ActNorm if use_actnorm else FlaxBatchNorm2d
        bias = use_actnorm  # BatchNorm has its own shift
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2**n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, 2 if n < n_layers else 1, 1,
                                 bias=bias), norm(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)
        self.weights_init()

    def weights_init(self) -> None:
        """Convs N(0, 0.02) (their biases stay at torch's default), BatchNorm
        γ ~ N(1, 0.02) and β = 0."""
        for m in self.main:
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, 0.02)
            elif isinstance(m, FlaxBatchNorm2d):
                nn.init.normal_(m.weight, 1.0, 0.02)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, stats: str = "eval") -> torch.Tensor:
        if stats not in STATS_MODES:
            raise ValueError(f"stats {stats!r} not in {STATS_MODES}")
        for m in self.main:
            x = m(x, stats) if isinstance(m, (FlaxBatchNorm2d, ActNorm)) else m(x)
        return x


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) → (B·T, C, H, W); frames pass through."""
    return x.reshape(-1, *x.shape[2:]) if x.ndim == 5 else x


def _norm_of(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.pow(2).sum() for g in grads))


class GeneralLPIPSWithDiscriminator(nn.Module):
    """The autoencoder's GAN loss. `generator_loss` is the optimizer_idx 0
    pass, `discriminator_loss` the optimizer_idx 1 pass; both return
    (loss, log) with the reference's log keys. `logvar` is a parameter; it
    trains only with `learn_logvar` (the trainer zeroes its gradient
    otherwise)."""

    def __init__(self, disc_start: int, logvar_init: float = 0.0, disc_num_layers: int = 3,
                 disc_in_channels: int = 3, disc_factor: float = 1.0, disc_weight: float = 1.0,
                 perceptual_weight: float = 1.0, disc_loss: str = "hinge",
                 scale_input_to_tgt_size: bool = False, dims: int = 2,
                 learn_logvar: bool = False,
                 regularization_weights: Optional[Dict[str, float]] = None,
                 additional_log_keys: Optional[Sequence[str]] = None,
                 discriminator_config: Optional[Dict] = None):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {disc_loss!r}")
        self.dims = dims  # scale_input_to_tgt_size: read by neither package
        self.perceptual_weight = float(perceptual_weight)
        # built only when weighted (the JAX package initialises its params so)
        self.perceptual_loss = LPIPS() if self.perceptual_weight > 0 else None
        self.learn_logvar = learn_logvar
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init)))
        self.discriminator = (
            NLayerDiscriminator(input_nc=disc_in_channels, n_layers=disc_num_layers)
            if discriminator_config is None else instantiate_from_config(discriminator_config))
        self.discriminator_iter_start = int(disc_start)
        self.disc_loss = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
        self.disc_factor = float(disc_factor)
        self.discriminator_weight = float(disc_weight)
        self.regularization_weights = dict(regularization_weights or {})
        self.additional_log_keys = set(additional_log_keys or []) | set(
            self.regularization_weights)

    def _rec_loss(self, inputs: torch.Tensor, reconstructions: torch.Tensor) -> torch.Tensor:
        rec = (inputs - reconstructions).abs()
        if self.perceptual_weight > 0:
            p = self.perceptual_loss(inputs, reconstructions)
            rec = rec + self.perceptual_weight * p[:, None, None, None]
        return rec

    def get_nll_loss(self, rec_loss: torch.Tensor, weights=None):
        """(Σ nll / B, Σ weights·nll / B), nll = rec / exp(logvar) + logvar."""
        nll = rec_loss / torch.exp(self.logvar) + self.logvar
        weighted = nll if weights is None else weights * nll
        bsz = rec_loss.shape[0]
        return nll.sum() / bsz, weighted.sum() / bsz

    def calculate_adaptive_weight(self, nll_loss: torch.Tensor, g_loss: torch.Tensor,
                                  last_layer: Sequence[torch.Tensor]) -> torch.Tensor:
        """‖∇_last nll‖ / (‖∇_last g‖ + 1e-4), clipped to [0, 1e4], times
        disc_weight, detached; the norms run over every tensor of
        `last_layer` (the JAX package's conv_out kernel and bias)."""
        gn = torch.autograd.grad(nll_loss, last_layer, retain_graph=True)
        gg = torch.autograd.grad(g_loss, last_layer, retain_graph=True)
        w = _norm_of(gn) / (_norm_of(gg) + 1e-4)
        return (w.clamp(0.0, 1e4) * self.discriminator_weight).detach()

    def generator_loss(self, inputs: torch.Tensor, reconstructions: torch.Tensor, *,
                       regularization_log: Optional[Dict[str, torch.Tensor]] = None,
                       global_step: int = 0, split: str = "train", weights=None,
                       train: bool = True,
                       last_layer: Optional[Sequence[torch.Tensor]] = None):
        """With `last_layer` in training the GAN term's weight is adaptive:
        the NLL's gradient against that of −mean D(x̂) with the
        discriminator on its running statistics, as the JAX package's
        second decode computes it; without it the weight is 1. The GAN term
        itself runs the discriminator on the batch's statistics and leaves
        its running ones alone. Before `disc_start` (in training) the GAN
        term and its weight are 0 and the discriminator does not run."""
        regularization_log = regularization_log or {}
        if self.dims > 2:
            inputs, reconstructions = _frames(inputs), _frames(reconstructions)
        rec_loss = self._rec_loss(inputs, reconstructions)
        nll_loss, weighted_nll = self.get_nll_loss(rec_loss, weights)
        zero = torch.zeros((), device=inputs.device)
        if train and global_step < self.discriminator_iter_start:
            g_loss = d_weight = zero
        else:
            g_loss = -self.discriminator(reconstructions, "batch" if train else "eval").mean()
            d_weight = zero + 1.0
            if train and last_layer is not None:
                g_eval = -self.discriminator(reconstructions, "eval").mean()
                d_weight = self.calculate_adaptive_weight(nll_loss, g_eval, list(last_layer))
        loss = weighted_nll + d_weight * self.disc_factor * g_loss
        log = {}
        for k, v in regularization_log.items():
            if k in self.regularization_weights:
                loss = loss + self.regularization_weights[k] * v
            if k in self.additional_log_keys:
                log[f"{split}/{k}"] = v.float().mean()
        log.update({f"{split}/loss/total": loss, f"{split}/loss/nll": nll_loss,
                    f"{split}/loss/rec": rec_loss.mean(), f"{split}/loss/g": g_loss,
                    f"{split}/scalars/logvar": self.logvar, f"{split}/scalars/d_weight": d_weight})
        return loss, log

    def discriminator_loss(self, inputs: torch.Tensor, reconstructions: torch.Tensor, *,
                           global_step: int = 0, split: str = "train", train: bool = True):
        """Logits of the real inputs, then of the detached reconstructions,
        each pass updating the running statistics in training; the loss is 0
        before `disc_start` (the discriminator still runs)."""
        if self.dims > 2:
            inputs, reconstructions = _frames(inputs), _frames(reconstructions)
        stats = "train" if train else "eval"
        logits_real = self.discriminator(inputs.detach(), stats)
        logits_fake = self.discriminator(reconstructions.detach(), stats)
        d_loss = self.disc_factor * self.disc_loss(logits_real, logits_fake)
        if train and global_step < self.discriminator_iter_start:
            d_loss = d_loss * 0.0
        log = {f"{split}/loss/disc": d_loss, f"{split}/logits/real": logits_real.mean(),
               f"{split}/logits/fake": logits_fake.mean()}
        return d_loss, log

    def forward(self, inputs, reconstructions, *, optimizer_idx: int, global_step: int,
                regularization_log=None, split: str = "train", weights=None, train: bool = True,
                **kw):
        if optimizer_idx == 0:
            return self.generator_loss(inputs, reconstructions,
                                       regularization_log=regularization_log,
                                       global_step=global_step, split=split, weights=weights,
                                       train=train, **kw)
        return self.discriminator_loss(inputs, reconstructions, global_step=global_step,
                                       split=split, train=train)


def _resize_cubic(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW resize with `jax.image.resize(..., "cubic")`'s arithmetic: Keys
    cubic (a = −0.5) at half-pixel centres, widened by the scale when
    shrinking (antialiased), weights renormalised over the taps inside the
    image."""
    for axis, n_out in ((2, size[0]), (3, size[1])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        x = torch.movedim(torch.tensordot(x, _cubic_matrix(n_in, n_out, x), dims=([axis], [1])),
                          -1, axis)
    return x


def _cubic_matrix(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) resampling weights of `_resize_cubic` along one axis."""
    scale = n_out / n_in
    kscale = min(scale, 1.0)  # antialias: the kernel widens by 1/scale when shrinking
    centres = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    src = torch.arange(n_in, dtype=torch.float64)
    t = (src[None, :] - centres[:, None]).abs() * kscale
    a = -0.5
    w = torch.where(t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                    torch.where(t < 2, ((a * t - 5 * a) * t + 8 * a) * t - 4 * a,
                                torch.zeros_like(t)))
    w = w / w.sum(dim=1, keepdim=True)
    return w.to(like.dtype).to(like.device)


class LatentLPIPS(nn.Module):
    """Latent L2 plus the LPIPS between the decoded target and predicted
    latents (`decoder_config` builds an engine with a `decode`), and
    optionally the LPIPS against the input images."""

    def __init__(self, decoder_config: Dict, perceptual_weight: float = 1.0,
                 latent_weight: float = 1.0, scale_input_to_tgt_size: bool = False,
                 scale_tgt_to_input_size: bool = False,
                 perceptual_weight_on_inputs: float = 0.0):
        super().__init__()
        self.decoder = instantiate_from_config(decoder_config)
        self.perceptual_loss = LPIPS()
        self.perceptual_weight = float(perceptual_weight)
        self.latent_weight = float(latent_weight)
        self.scale_input_to_tgt_size = scale_input_to_tgt_size
        self.scale_tgt_to_input_size = scale_tgt_to_input_size
        self.perceptual_weight_on_inputs = float(perceptual_weight_on_inputs)

    def forward(self, latent_inputs: torch.Tensor, latent_predictions: torch.Tensor,
                image_inputs: torch.Tensor, split: str = "train"):
        log = {}
        loss = (latent_inputs - latent_predictions) ** 2
        log[f"{split}/latent_l2_loss"] = loss.mean()
        image_reconstructions = None
        if self.perceptual_weight > 0.0:
            image_reconstructions = self.decoder.decode(latent_predictions)
            image_targets = self.decoder.decode(latent_inputs)
            p = self.perceptual_loss(image_targets, image_reconstructions)
            loss = self.latent_weight * loss.mean() + self.perceptual_weight * p.mean()
            log[f"{split}/perceptual_loss"] = p.mean()
        if self.perceptual_weight_on_inputs > 0.0:
            if image_reconstructions is None:
                image_reconstructions = self.decoder.decode(latent_predictions)
            if self.scale_input_to_tgt_size:
                image_inputs = _resize_cubic(image_inputs, image_reconstructions.shape[2:])
            elif self.scale_tgt_to_input_size:
                image_reconstructions = _resize_cubic(image_reconstructions,
                                                      image_inputs.shape[2:])
            p2 = self.perceptual_loss(image_inputs, image_reconstructions)
            loss = loss + self.perceptual_weight_on_inputs * p2.mean()
            log[f"{split}/perceptual_loss_on_inputs"] = p2.mean()
        return loss, log
