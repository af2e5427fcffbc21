"""DiffusionEngine, the stage-1 VideoLDM and the stage-2 VideoLDMStage2
(counterpart of hi3d_tpu/engine.py).

The engine is an `nn.Module` whose children carry the reference's attribute
names — `model.diffusion_model` (UNet behind the concat wrapper),
`first_stage_model` (VAE), `conditioner.embedders.N` — so its state dict has
the reference's keys. The UNet computes in `compute_dtype` (bf16 on the card)
whatever its weights' dtype: inference casts the weights, training keeps fp32
master weights and the UNet autocasts (models/unet.py). The VAE runs in fp32;
σ-math is fp32. Latents and frames are channels-last at the public boundary,
as in the JAX package.

Training surface: `make_loss_fn` / `shared_step` (VAE encode, conditioner
with ucg dropout, StandardDiffusionLoss), `trained_param_keys`,
`scheduler_config`, `use_ema`, `base_learning_rate`; hi3d_tpu_torch.training
drives them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from .config import instantiate_from_config
from .models.wrappers import ConcatConditionWrapper
from .utils.misc import append_dims, default

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _fit_indicator(indicator: torch.Tensor, x: torch.Tensor, num_video_frames: int):
    """A CFG-doubled (2b, t) indicator for an un-doubled x takes its c half."""
    b = x.shape[0] // num_video_frames
    return indicator[b:] if indicator.shape[0] == 2 * b else indicator


class DiffusionEngine(nn.Module):
    def __init__(
        self,
        network_config: Dict,
        denoiser_config: Dict,
        first_stage_config: Dict,
        conditioner_config: Optional[Dict] = None,
        sampler_config: Optional[Dict] = None,
        ckpt_path: Optional[str] = None,
        scale_factor: float = 1.0,
        en_and_decode_n_samples_a_time: Optional[int] = None,
        decode_tile_size: Optional[int] = 96,
        compute_dtype: str = "float32",
        loss_fn_config: Optional[Dict] = None,
        scheduler_config: Optional[Dict] = None,
        use_ema: bool = False,
        ema_decay_rate: float = 0.9999,
        base_learning_rate: Optional[float] = None,
        input_key: str = "jpg",
        log_keys: Optional[Sequence[str]] = None,
        disable_first_stage_autocast: bool = True,  # the VAE runs in fp32 regardless
    ):
        super().__init__()
        self.compute_dtype = _DTYPES[compute_dtype]
        self.scale_factor = float(scale_factor)
        self.en_and_decode_n_samples_a_time = en_and_decode_n_samples_a_time
        # the JAX engine decodes latents wider than this in feathered tiles;
        # the port decodes untiled and refuses wider latents (none of the
        # configs reaches it: 64² at stage 1, 128² ≤ 128 at stage 2)
        self.decode_tile_size = decode_tile_size
        self.input_key = input_key
        self.scheduler_config = scheduler_config
        self.use_ema = bool(use_ema)
        self.ema_decay_rate = float(ema_decay_rate)
        self.base_learning_rate = base_learning_rate
        self.loss_fn = instantiate_from_config(loss_fn_config) if loss_fn_config else None
        net_params = dict(network_config.get("params") or {})
        net_params.setdefault("dtype", compute_dtype)
        self.model = ConcatConditionWrapper(
            instantiate_from_config({"target": network_config["target"], "params": net_params})
        )
        self.denoiser = instantiate_from_config(denoiser_config)
        self.sampler = instantiate_from_config(sampler_config) if sampler_config else None
        self.conditioner = (
            instantiate_from_config(conditioner_config) if conditioner_config else None
        )
        self.first_stage_model = instantiate_from_config(first_stage_config)
        self.eval()
        if ckpt_path is not None:
            self.init_from_ckpt(ckpt_path)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_from_ckpt(self, path) -> None:
        """Load a reference checkpoint (file path or in-memory state dict):
        each engine part present in it loads with strict=True."""
        from .convert import load_checkpoint_file, load_reference_state_dict, strip_deepspeed

        sd = strip_deepspeed(path) if isinstance(path, dict) else load_checkpoint_file(path)
        parts = [("model.diffusion_model.", self.model.diffusion_model),
                 ("first_stage_model.", self.first_stage_model)]
        if self.conditioner is not None:
            parts += [(f"conditioner.embedders.{n}.", emb)
                      for n, emb in enumerate(self.conditioner.embedders)
                      if emb.loads_engine_checkpoint]
        for prefix, module in parts:
            if any(k.startswith(prefix) for k in sd):
                load_reference_state_dict(module, sd, prefix)

    def cast_weights_to_compute_dtype(self, include_towers: bool = True,
                                      include_first_stage: bool = False) -> None:
        """Inference cast: the UNet (and the conditioner towers) to
        compute_dtype; the VAEs only with `include_first_stage`."""
        dt = self.compute_dtype
        self.model.to(dt)
        if self.conditioner is not None:
            for emb in self.conditioner.embedders:
                for name in ("open_clip", "clip", "mlp"):
                    if include_towers and hasattr(emb, name):
                        getattr(emb, name).to(dt)
                if include_first_stage and hasattr(emb, "encoder"):
                    emb.encoder.to(dt)
        if include_first_stage:
            self.first_stage_model.to(dt)

    def _chunked(self, fn, x: torch.Tensor) -> torch.Tensor:
        n = self.en_and_decode_n_samples_a_time or x.shape[0]
        return torch.cat([fn(x[i:i + n]) for i in range(0, x.shape[0], n)], dim=0)

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [-1, 1] → scaled latents (N, H/8, W/8, 4)."""
        dt = self.first_stage_model.quant_conv.weight.dtype
        z = self._chunked(lambda v: self.first_stage_model.encode(v.to(dt)),
                          x.permute(0, 3, 1, 2))
        return (self.scale_factor * z.float()).to(self.compute_dtype).permute(0, 2, 3, 1)

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """(N, h, w, 4) latents → (N, 8h, 8w, 3) fp32 frames, in chunks; a
        latent wider than `decode_tile_size` decodes in tiles
        (`AutoencoderKL.decode_tiled`, its default overlap)."""
        vae = self.first_stage_model
        tile = self.decode_tile_size
        tiled = tile is not None and max(z.shape[1:3]) > tile
        dt = vae.post_quant_conv.weight.dtype

        def dec(v):
            v = ((1.0 / self.scale_factor) * v.float()).to(dt)
            return (vae.decode_tiled(v, tile=tile) if tiled else vae.decode(v)).float()

        return self._chunked(dec, z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    @torch.no_grad()
    def sample(self, cond: Dict, uc: Optional[Dict] = None, shape: Optional[Sequence[int]] = None,
               num_video_frames: Optional[int] = None,
               image_only_indicator: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, randn=None,
               num_steps: Optional[int] = None) -> torch.Tensor:
        """Run the CFG sampling loop. `shape` and `randn` (optional initial
        unit noise) are channels-last (T, h, w, 4); so is the result."""
        device = self.device
        if randn is None:
            randn = torch.randn(tuple(shape), generator=generator, device=device)
        else:
            randn = torch.as_tensor(randn, device=device, dtype=torch.float32)
        t = default(num_video_frames, randn.shape[0])
        if image_only_indicator is None:
            image_only_indicator = torch.zeros((2 * (randn.shape[0] // t), t), device=device)
        x = randn.permute(0, 3, 1, 2).to(self.compute_dtype).contiguous()

        def denoiser(xx, sigma, c):
            return self.denoiser(
                self.model, xx, sigma, c, num_video_frames=t,
                image_only_indicator=_fit_indicator(image_only_indicator, xx, t),
            )

        out = self.sampler(denoiser, x, cond, uc=uc, num_steps=num_steps)
        return out.permute(0, 2, 3, 1)


class VideoLDM(DiffusionEngine):
    """Stage-1 image-to-orbit-video model."""

    def __init__(self, num_samples: int, trained_param_keys: Sequence[str] = ("",), **kwargs):
        super().__init__(**kwargs)
        self.num_samples = int(num_samples)
        self.trained_param_keys = list(trained_param_keys)

    @property
    def num_samples(self) -> int:
        return self._num_samples

    @num_samples.setter
    def num_samples(self, value: int) -> None:
        """A new clip length retargets the frame-tied parts: embedders whose
        n_copies equals the old length, and the per-frame CFG guider."""
        value = int(value)
        old = getattr(self, "_num_samples", None)
        self._num_samples = value
        if old in (None, value):
            return
        if self.conditioner is not None:
            for emb in self.conditioner.embedders:
                if getattr(emb, "n_copies", None) == old:
                    emb.n_copies = value
        guider = getattr(self.sampler, "guider", None)
        if guider is not None and getattr(guider, "num_frames", None) == old:
            guider.num_frames = value
            guider.scale = torch.linspace(guider.min_scale, guider.max_scale, value,
                                          dtype=torch.float32)

    def add_custom_cond(self, batch: Dict, infer: bool = False,
                        generator: Optional[torch.Generator] = None) -> Dict:
        """cond_frames(_without_noise), cond_aug and image_only_indicator from
        batch['video'] (B, T, 3, H, W) in [-1, 1]."""
        batch = dict(batch)
        batch["num_video_frames"] = self.num_samples
        video = batch["video"]
        image = video[:, 0]
        batch["cond_frames_without_noise"] = image
        n = video.shape[0]
        if infer:
            cond_aug = torch.full((n,), 0.02, device=video.device)
        else:
            cond_aug = torch.exp(-3.0 + 0.5 * torch.randn((n,), generator=generator,
                                                          device=video.device))
        batch["cond_aug"] = cond_aug
        noise = torch.randn(image.shape, generator=generator, device=image.device,
                            dtype=image.dtype)
        batch["cond_frames"] = image + append_dims(cond_aug, image.ndim).to(image.dtype) * noise
        if "image_only_indicator" not in batch:
            batch["image_only_indicator"] = torch.zeros((n, self.num_samples), device=video.device)
        return batch

    def shared_step(self, batch: Dict, generator: Optional[torch.Generator] = None):
        """Training objective on one batch; returns (loss, {"loss": loss})."""
        batch = self.add_custom_cond(batch, infer=False, generator=generator)
        loss = self.make_loss_fn()(batch, generator)
        return loss, {"loss": loss}

    def make_loss_fn(self):
        """loss(batch, generator) → mean loss over frames, differentiable in
        the UNet's parameters. `batch` has been through `add_custom_cond`:
        the fp32 VAE encodes batch[input_key] (B, T, 3, H, W), the conditioner
        runs with ucg dropout, StandardDiffusionLoss draws σ and ε."""
        if self.loss_fn is None:
            raise ValueError("make_loss_fn needs loss_fn_config")

        def loss_fn(batch: Dict, generator: Optional[torch.Generator] = None) -> torch.Tensor:
            video = batch[self.input_key]
            b, t = video.shape[:2]
            frames = video.reshape(b * t, *video.shape[2:]).permute(0, 2, 3, 1)
            x = self.encode_first_stage(frames).permute(0, 3, 1, 2).contiguous()
            cond = self.conditioner(batch, generator=generator)
            bound = {"num_video_frames": t, "image_only_indicator": batch["image_only_indicator"]}

            def network(xx, c_noise, c, **extra):
                return self.model(xx, c_noise, c, **{**extra, **bound})  # bound keys win

            loss = self.loss_fn(network, self.denoiser, cond, x, batch, generator)
            return loss.mean()

        return loss_fn


class VideoLDMStage2(VideoLDM):
    """Stage-2 video-to-video refiner (JAX engine.VideoLDMStage2): the
    conditioning video is the input video itself at inference; the depth
    channels come from the conditioner's DepthEmbedder."""

    def add_custom_cond(self, batch: Dict, infer: bool = False,
                        generator: Optional[torch.Generator] = None) -> Dict:
        """cond_frames_without_noise = video[:, 0]; cond_frames = every frame
        of the video (B·T, 3, H, W) plus cond_aug (0.02) Gaussian noise —
        the noise augmentation applies at inference too; image_only_indicator
        zeros."""
        if not infer:
            raise NotImplementedError(
                "stage-2 training (degradation of the conditioning video, data/degradation.py) "
                "is not ported yet: it is the stage-2 training slice (ROADMAP)")
        batch = dict(batch)
        batch["num_video_frames"] = self.num_samples
        video = batch["video"]  # (B, T, 3, H, W)
        n = video.shape[0]
        batch["cond_frames_without_noise"] = video[:, 0]
        cond_aug = torch.full((n,), 0.02, device=video.device)
        frames = video.reshape(-1, *video.shape[2:])
        aug = cond_aug.repeat_interleave(self.num_samples)
        noise = torch.randn(frames.shape, generator=generator, device=frames.device,
                            dtype=frames.dtype)
        batch["cond_frames"] = frames + append_dims(aug, frames.ndim).to(frames.dtype) * noise
        batch["cond_aug"] = cond_aug
        if "image_only_indicator" not in batch:
            batch["image_only_indicator"] = torch.zeros((n, self.num_samples), device=video.device)
        return batch
