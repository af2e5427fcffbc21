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
drives them. `log_images` and `log_conditionings` make the image logger's
media: numpy in the JAX package's layout, (n, T, H, W, 3) in [-1, 1].
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .config import instantiate_from_config
from .models.wrappers import ConcatConditionWrapper
from .utils.misc import append_dims, default

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _fit_indicator(indicator: torch.Tensor, x: torch.Tensor, num_video_frames: int,
                   frames=None):
    """A CFG-doubled (2b, t) indicator for an un-doubled x takes its c half
    (b: the videos of x, or with `frames` of the batch whose rows x holds)."""
    b = (frames.videos * frames.copies(x.shape[0]) if frames is not None
         else x.shape[0] // num_video_frames)
    return indicator[b:] if indicator.shape[0] == 2 * b else indicator


@functools.lru_cache(maxsize=32)
def _sampler_call_params(cls) -> frozenset:
    """The parameter names of a sampler class's `__call__`: the modes a
    sampler takes are the ones its signature names."""
    return frozenset(inspect.signature(cls.__call__).parameters)


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
        no_cond_log: bool = False,
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
        self.log_keys = log_keys  # a list or, as the configs give it, a string (JAX: `in`)
        self.no_cond_log = bool(no_cond_log)
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

    def make_denoiser_fn(self, num_video_frames: int, image_only_indicator: torch.Tensor,
                     cached: bool = False, frame_shard=None):
        """denoiser(x, sigma, cond) over the UNet with the bound frame count and
        indicator (its conditioned half on an un-doubled x); `cached`:
        denoiser(x, sigma, cond, cache) → (denoised, cache), where cache None
        runs the whole UNet and returns its fresh (skips, middle h) and a
        given cache decodes from it and is passed through (encoder reuse).
        `frame_shard` (latency mode): x holds this rank's rows of the batch,
        the indicator is the whole batch's, and the UNet runs frame-parallel."""
        t = num_video_frames
        shard_kw = {} if frame_shard is None else {"frame_shard": frame_shard}

        def bound(xx, **kw):
            return dict(num_video_frames=t, image_only_indicator=_fit_indicator(
                image_only_indicator, xx, t, frame_shard), **shard_kw, **kw)

        if not cached:
            return lambda xx, sigma, c: self.denoiser(self.model, xx, sigma, c, **bound(xx))

        def dfn(xx, sigma, c, cache=None):
            if cache is not None:
                return self.denoiser(self.model, xx, sigma, c,
                                     **bound(xx, encoder_cache=cache)), cache
            cell = {}

            def network(x_in, c_noise, cc, **extra):
                out, cell["cache"] = self.model(x_in, c_noise, cc, return_encoder_cache=True,
                                                **extra)
                return out

            return self.denoiser(network, xx, sigma, c, **bound(xx)), cell["cache"]

        return dfn

    @torch.no_grad()
    def sample(self, cond: Dict, uc: Optional[Dict] = None, shape: Optional[Sequence[int]] = None,
               num_video_frames: Optional[int] = None,
               image_only_indicator: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, randn=None,
               num_steps: Optional[int] = None, encoder_reuse: int = 0,
               cfg_interval: Optional[Tuple[float, float]] = None,
               frames=None) -> torch.Tensor:
        """Run the sampling loop. `shape` and `randn` (optional initial unit
        noise) are channels-last (T, h, w, 4); so is the result. `generator`
        draws the initial noise and the sampler's own (churn, ancestral).

        `frames` (a `parallel.dist.FrameShard`): this process runs the rows
        it holds of the (B·T) batch that `shape` and `randn` describe, and
        returns those rows; every draw is the whole batch's, cut to them. With
        a group (latency mode) the UNet runs frame-parallel over it and the
        indicator is the whole batch's; without one the rows are whole
        videos and the UNet sees them alone.

        `encoder_reuse=k`: the UNet encoder runs only every k-th step
        (approximate for k ≥ 2); `cfg_interval=(lo, hi)`: CFG only where
        σ ∈ [lo, hi] (exact when it covers the schedule). Both are opt-in,
        mutually exclusive and taken only by samplers whose `__call__` has
        the parameter (the EDM Euler/Heun family)."""
        device = self.device
        if randn is None:
            randn = torch.randn(tuple(shape), generator=generator, device=device)
        else:
            randn = torch.as_tensor(randn, device=device, dtype=torch.float32)
        t = default(num_video_frames, randn.shape[0])
        parallel = frames is not None and frames.group is not None
        videos = (randn.shape[0] if parallel or frames is None else frames.count) // t
        if frames is not None:
            randn = frames.take(randn)
        if image_only_indicator is None:
            image_only_indicator = torch.zeros((2 * videos, t), device=device)
        x = randn.permute(0, 3, 1, 2).to(self.compute_dtype).contiguous()
        params = _sampler_call_params(type(self.sampler))
        if encoder_reuse and cfg_interval is not None:
            raise ValueError("cfg_interval and encoder_reuse are mutually exclusive")
        kw = {}
        if encoder_reuse:
            kw["encoder_reuse"] = int(encoder_reuse)
        if cfg_interval is not None:
            kw["cfg_interval"] = tuple(cfg_interval)
        for name in kw:
            if name not in params:
                raise ValueError(f"sampler {type(self.sampler).__name__} does not support "
                                 f"{name} (EDM Euler/Heun family only)")
        denoiser = self.make_denoiser_fn(t, image_only_indicator, cached=bool(encoder_reuse),
                                         frame_shard=frames if parallel else None)
        with self.sampler.use_frames(frames):
            out = self.sampler(denoiser, x, cond, uc=uc, num_steps=num_steps,
                               generator=generator, **kw)
        return out.permute(0, 2, 3, 1)

    def log_conditionings(self, batch: Dict, n: int) -> Dict[str, np.ndarray]:
        """Loggable conditioning inputs as caption images (the JAX engine's
        `log_conditionings`): for each embedder whose key is in the batch
        (and in `log_keys` when set), strings are drawn at H/20 px, one value
        a sample at H/4 and rows of values "x"-joined at H/20, H and W the
        batch's frames'. Empty with `no_cond_log`."""
        from .utils.image import log_txt_as_img

        if self.no_cond_log:
            return {}
        image_h, image_w = batch[self.input_key].shape[-2:]
        log: Dict[str, np.ndarray] = {}
        for emb in self.conditioner.embedders:
            key = emb.input_key
            if key is None or key not in batch:
                continue
            if self.log_keys is not None and key not in self.log_keys:
                continue
            x = batch[key]
            if isinstance(x, (list, tuple)) and x and isinstance(x[0], str):
                log[key] = log_txt_as_img((image_w, image_h), list(x[:n]), size=image_h // 20)
                continue
            x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)[:n]
            if x.ndim == 1:
                log[key] = log_txt_as_img((image_w, image_h), [str(v) for v in x.tolist()],
                                          size=image_h // 4)
            elif x.ndim == 2:
                log[key] = log_txt_as_img((image_w, image_h),
                                          ["x".join(str(v) for v in row) for row in x.tolist()],
                                          size=image_h // 20)
        return log


def _first(batch: Dict, n: int) -> Dict:
    """The batch's first `n` videos: tensors and arrays with a leading axis
    and lists are cut, everything else is kept."""
    return {k: v[:n] if isinstance(v, list) or getattr(v, "ndim", 0) >= 1 else v
            for k, v in batch.items()}


@contextlib.contextmanager
def _eval_mode(module: nn.Module):
    """Within: every submodule in eval mode, under `torch.no_grad`; each
    module's own training flag comes back after."""
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        for m, mode in modes:
            m.training = mode


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

    def log_images(self, batch: Dict, n: int = 1, sample: bool = True,
                   generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
        """The image logger's media for the batch's first `n` videos (the JAX
        engine's `log_images`), each (n, T, H, W, 3) float32 in [-1, 1]:
        `inputs`; `conditioning`, the caption drawn at 512² and size 16,
        when the batch has a caption and `no_cond_log` is off; the fp32 VAE's
        `reconstructions`; and with `sample`, `samples`: one run of the
        config's sampler on the conditioner's (c, uc) with cond_frames and
        cond_frames_without_noise zeroed in uc, decoded. Runs in eval mode
        without gradients; every draw comes from `generator` (a fresh one
        seeded 0 when None). The JAX engine conditions on the whole batch,
        which fails for more videos than `n`; here the batch is cut first."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with _eval_mode(self):
            batch = self.add_custom_cond(_first(batch, n), infer=True, generator=generator)
            video = batch[self.input_key]
            b, t = video.shape[:2]
            frames = video.reshape(b * t, *video.shape[2:]).permute(0, 2, 3, 1)

            def clip(x: torch.Tensor) -> np.ndarray:
                return x.float().reshape(b, t, *x.shape[1:]).cpu().numpy()

            log: Dict[str, np.ndarray] = {"inputs": clip(frames)}
            if "caption" in batch and not self.no_cond_log:
                from .utils.image import log_txt_as_img

                caps = batch["caption"]
                log["conditioning"] = log_txt_as_img(
                    (512, 512), [caps] if isinstance(caps, str) else caps[:n], size=16)
            z = self.encode_first_stage(frames)
            log["reconstructions"] = clip(self.decode_first_stage(z))
            if sample and self.sampler is not None and self.conditioner is not None:
                c, uc = self.conditioner.get_unconditional_conditioning(
                    batch, force_uc_zero_embeddings=["cond_frames", "cond_frames_without_noise"])
                samples = self.sample(cond=c, uc=uc, shape=(b * t, *z.shape[1:]),
                                      num_video_frames=t, generator=generator)
                log["samples"] = clip(self.decode_first_stage(samples))
        return log

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
    conditioning video is the input video itself at inference and its
    Real-ESRGAN degradation in training (data/degradation.py, on the
    video's device); the depth channels come from the conditioner's
    DepthEmbedder."""

    def __init__(self, *args, **kwargs):
        from .data.degradation import DegradedImages

        super().__init__(*args, **kwargs)
        self.degradation = DegradedImages()

    def add_custom_cond(self, batch: Dict, infer: bool = False,
                        generator: Optional[torch.Generator] = None) -> Dict:
        """cond_frames_without_noise = video[:, 0]; cond_frames = every frame
        of the conditioning video (B·T, 3, H, W) plus cond_aug-scaled
        Gaussian noise (the augmentation applies at inference too);
        image_only_indicator zeros.

        Inference: the conditioning video is batch['video'], cond_aug 0.02.
        Training: it is the video degraded with the batch's masks and
        kernels (whatever `masks`, `kernel1s`, `kernel2s`, `sinc_kernels`
        the batch holds), cond_aug = exp(-3 + 0.5·N(0, 1)) per video. The
        degradation's RandomState is seeded from `generator`, which also
        draws its noise fields, so one seed gives one degraded video."""
        batch = dict(batch)
        batch["num_video_frames"] = self.num_samples
        video = batch["video"]  # (B, T, 3, H, W)
        n = video.shape[0]
        dev = video.device
        batch["cond_frames_without_noise"] = video[:, 0]
        if infer:
            cond_video = video
            cond_aug = torch.full((n,), 0.02, device=dev)
        else:
            gen_dev = generator.device if generator is not None else dev
            seed = int(torch.randint(2**31 - 1, (1,), generator=generator, device=gen_dev))
            cond_video = self.degradation(
                video, batch.get("masks"), kernel1s=batch.get("kernel1s"),
                kernel2s=batch.get("kernel2s"), sinc_kernels=batch.get("sinc_kernels"),
                rng=np.random.RandomState(seed), generator=generator).to(video.dtype)
            cond_aug = torch.exp(-3.0 + 0.5 * torch.randn((n,), generator=generator, device=dev))
        frames = cond_video.reshape(-1, *cond_video.shape[2:])
        aug = cond_aug.repeat_interleave(self.num_samples)
        noise = torch.randn(frames.shape, generator=generator, device=frames.device,
                            dtype=frames.dtype)
        batch["cond_frames"] = frames + append_dims(aug, frames.ndim).to(frames.dtype) * noise
        batch["cond_aug"] = cond_aug
        if "image_only_indicator" not in batch:
            batch["image_only_indicator"] = torch.zeros((n, self.num_samples), device=dev)
        return batch

    def log_images(self, batch: Dict, n: int = 1, sample: bool = True,
                   generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
        """The stage-1 media, then a second conditioner pass on the clean
        video with ucg off: `depth-video`, the DepthEmbedder's s² concat
        channels folded back by its own pixel-unshuffle's inverse to
        (n, T, s·h, s·w) grey → RGB in [-1, 1], and `cond-video`, the last
        concat channels decoded as raw latents (z_cond · scale_factor), as
        the JAX engine does."""
        from .conditioners import DepthEmbedder

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        log = super().log_images(batch, n=n, sample=sample, generator=generator)
        if self.conditioner is None:
            return log
        (depth_emb,) = [e for e in self.conditioner.embedders if isinstance(e, DepthEmbedder)]
        s = depth_emb.shuffle_size
        with _eval_mode(self):
            cbatch = self.add_custom_cond(_first(batch, n), infer=True, generator=generator)
            c = self.conditioner(cbatch, ucg_enabled=False)
            b, t = cbatch["video"].shape[:2]
            concat = c["concat"].float()
            depth = torch.nn.functional.pixel_shuffle(concat[:, : s * s], s)
            depth = depth.expand(-1, 3, -1, -1) * 2.0 - 1.0
            log["depth-video"] = depth.permute(0, 2, 3, 1).reshape(
                b, t, *depth.shape[2:], 3).cpu().numpy()
            z_cond = concat[:, s * s:] * self.scale_factor
            dec = self.decode_first_stage(z_cond.permute(0, 2, 3, 1))
            log["cond-video"] = dec.reshape(b, t, *dec.shape[1:]).cpu().numpy()
        return log
