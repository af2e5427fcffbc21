"""Conditioning: GeneralConditioner, the stage-1 and stage-2 embedders and
the rest of sgm's embedder set (counterpart of hi3d_tpu/conditioners.py):
the text encoders (OpenCLIP ViT-H/14, CLIP ViT-L/14, T5, ByT5, CLIP + T5),
class labels, spatial rescaling, the low-scale and Gaussian encoders.

NCHW throughout: frames are (N, 3, H, W) and videos (B, T, 3, H, W) in
[-1, 1]. An embedder returns one tensor or a list or tuple of them; each
routes by rank into {vector (B, D), crossattn (B, S, C), concat (B, C, h,
w)} and concatenates along the reference's dims (1, 2, 1). An embedder reads
one batch key (`input_key`) or several (`input_keys`, passed in order). The
embedders that draw (`draws = True`: LowScaleEncoder, GaussianEncoder,
VideoPredictionEmbedderWithEncoder) take
a `generator` keyword; their draws are the port's own stream, as ucg's are.
The towers load their released files when present and otherwise keep a
random initialisation, with a printed notice. The text encoders take token
ids (B, L): the CLIP BPE vocabulary is not in the repository, so raw
strings raise, and T5's raw strings reach its tokenizer only where
`transformers` imports.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import instantiate_from_config
from .models.autoencoding import DiagonalGaussianRegularizer
from .models.clip import (
    AestheticMLP,
    clip_normalize,
    image_resize,
    resize_bicubic,
    resize_bilinear,
    text_vit_h_14,
    text_vit_l_14,
    vit_h_14,
    vit_l_14,
)
from .models.dpt import DPTDepthModel
from .models.layers import timestep_embedding
from .models.vae import Encoder
from .utils.misc import append_dims

CondDict = Dict[str, torch.Tensor]


def _tower_file_notice(name: str, path: Optional[str]) -> None:
    print(f"[conditioner] {name}: weight file {path!r} not found — random init")


def _load_visual(tower: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    visual = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    tower.load_state_dict(visual, strict=True)


class AbstractEmbedder(nn.Module):
    """An embedder computes conditioning from one batch key (`input_key`)
    or several (`input_keys`)."""

    OUT_KEY_BY_NDIM = {2: "vector", 3: "crossattn", 4: "concat"}
    # whether an engine checkpoint's `conditioner.embedders.N.*` keys load here
    loads_engine_checkpoint = True
    # whether forward takes a `generator` to draw from
    draws = False

    def __init__(self):
        super().__init__()
        self.input_key: Optional[str] = None
        self.input_keys: Optional[List[str]] = None
        self.ucg_rate = 0.0

    def embed(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        """The embedder on its batch values, as a list of output tensors."""
        args = ([batch[self.input_key]] if self.input_key is not None
                else [batch[k] for k in self.input_keys])
        out = self(*args, generator=generator) if self.draws else self(*args)
        return list(out) if isinstance(out, (list, tuple)) else [out]


class GeneralConditioner(nn.Module):
    CAT_DIM = {"vector": 1, "crossattn": 2, "concat": 1}

    def __init__(self, emb_models: Sequence[Dict]):
        super().__init__()
        self.embedders = nn.ModuleList()
        for n, cfg in enumerate(emb_models):
            emb = instantiate_from_config(cfg)
            if not isinstance(emb, AbstractEmbedder):
                raise TypeError(f"embedder {type(emb).__name__} must inherit AbstractEmbedder")
            if "input_key" in cfg:
                emb.input_key = cfg["input_key"]
            elif "input_keys" in cfg:
                emb.input_keys = list(cfg["input_keys"])
            else:
                raise KeyError(f"embedder #{n} needs 'input_key(s)'")
            emb.ucg_rate = float(cfg.get("ucg_rate", 0.0))
            self.embedders.append(emb)
        # parity-test hook: one (N,) keep mask per embedder (None where it has
        # no ucg) replacing the Bernoulli draws, as the loss pins σ and ε
        self.parity_ucg_keep: Optional[Sequence[Optional[torch.Tensor]]] = None

    def _add(self, out: CondDict, key: str, emb: torch.Tensor) -> None:
        out[key] = torch.cat([out[key], emb], dim=self.CAT_DIM[key]) if key in out else emb

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any], force_zero_embeddings: Optional[Sequence[str]] = None,
                generator: Optional[torch.Generator] = None, ucg_enabled: bool = True) -> CondDict:
        """Embed every key; with a generator (or `parity_ucg_keep`), drop each
        embedder's outputs per sample with probability ucg_rate (training-time
        CFG dropout; one mask for all of an embedder's outputs). The
        embedders that draw take the same generator."""
        force_zero = force_zero_embeddings or []
        out: CondDict = {}
        pinned = self.parity_ucg_keep
        for n, emb_mod in enumerate(self.embedders):
            drop = ucg_enabled and emb_mod.ucg_rate > 0.0 and (generator is not None
                                                               or pinned is not None)
            keep = None
            for emb in emb_mod.embed(batch, generator):
                key = AbstractEmbedder.OUT_KEY_BY_NDIM[emb.ndim]
                if drop:
                    if keep is None:
                        keep = (torch.as_tensor(pinned[n], dtype=torch.float32, device=emb.device)
                                if pinned is not None else torch.bernoulli(
                                    torch.full((emb.shape[0],), 1.0 - emb_mod.ucg_rate,
                                               device=emb.device), generator=generator))
                    emb = append_dims(keep, emb.ndim).to(emb.dtype) * emb
                if emb_mod.input_key in force_zero:
                    emb = torch.zeros_like(emb)
                self._add(out, key, emb)
        return out

    @torch.no_grad()
    def get_unconditional_conditioning(
        self, batch_c: Dict[str, Any], batch_uc: Optional[Dict[str, Any]] = None,
        force_uc_zero_embeddings: Optional[Sequence[str]] = None,
        force_cond_zero_embeddings: Optional[Sequence[str]] = None,
    ) -> Tuple[CondDict, CondDict]:
        """(c, uc) with ucg disabled. Without `batch_uc`, one tower pass builds
        both: uc differs from c only where force-zero keys zero it."""
        if batch_uc is not None:
            return (self(batch_c, force_cond_zero_embeddings, ucg_enabled=False),
                    self(batch_uc, force_uc_zero_embeddings, ucg_enabled=False))
        force_c = force_cond_zero_embeddings or []
        force_uc = force_uc_zero_embeddings or []
        c: CondDict = {}
        uc: CondDict = {}
        for emb_mod in self.embedders:
            for emb in emb_mod.embed(batch_c):
                key = AbstractEmbedder.OUT_KEY_BY_NDIM[emb.ndim]
                for out, forced in ((c, force_c), (uc, force_uc)):
                    self._add(out, key,
                              torch.zeros_like(emb) if emb_mod.input_key in forced else emb)
        return c, uc


class ConcatTimestepEmbedderND(AbstractEmbedder):
    """Sinusoidal embedding of each scalar dim, flattened (elevation, cond_aug)."""

    def __init__(self, outdim: int):
        super().__init__()
        self.outdim = int(outdim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 1:
            x = x[:, None]
        b, dims = x.shape
        return timestep_embedding(x.reshape(-1), self.outdim).reshape(b, dims * self.outdim)


class FrozenOpenCLIPImageEmbedder(AbstractEmbedder):
    """OpenCLIP ViT-H/14 pooled embedding of (N, 3, H, W) frames in [-1, 1]."""

    def __init__(self, arch: str = "ViT-H-14", version: Optional[str] = None,
                 freeze: bool = True, antialias: bool = True, unsqueeze_dim: bool = False,
                 **_unused):
        super().__init__()
        if arch != "ViT-H-14":
            raise NotImplementedError(f"arch {arch} (Hi3D uses ViT-H-14)")
        self.model = nn.Module()
        self.model.visual = vit_h_14()
        self.unsqueeze_dim = unsqueeze_dim
        if version and os.path.exists(version):
            _load_visual(self.model.visual, torch.load(version, map_location="cpu",
                                                       weights_only=True))
        else:
            _tower_file_notice("OpenCLIP ViT-H-14", version)

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        x = resize_bicubic(x.float(), (224, 224))
        return clip_normalize((x + 1.0) / 2.0)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        z = self.model.visual(self.preprocess(image))
        return z[:, None, :] if self.unsqueeze_dim else z


class FrozenOpenCLIPImagePredictionEmbedder(AbstractEmbedder):
    """CLIP embedding of n_cond_frames, repeated n_copies → (B·n, T, 1024)."""

    def __init__(self, open_clip_embedding_config: Dict, n_cond_frames: int, n_copies: int):
        super().__init__()
        self.n_cond_frames = int(n_cond_frames)
        self.n_copies = int(n_copies)
        self.open_clip = instantiate_from_config(open_clip_embedding_config)

    def forward(self, vid: torch.Tensor) -> torch.Tensor:
        z = self.open_clip(vid)
        z = z.reshape(-1, self.n_cond_frames, z.shape[-1])
        return z.repeat_interleave(self.n_copies, dim=0)


class VideoPredictionEmbedderWithEncoder(AbstractEmbedder):
    """VAE-mode latents of the conditioning frame(s) → concat input
    (B·n_copies, n_cond_frames·C, h, w), frame-major channel packing.

    With `sigma_sampler_config` (hi3d_tpu/conditioners.py:329-352) the
    frames first get noise: one σ per video from the sampler, repeated over
    its conditioning frames, times unit normals of the frames' shape, drawn
    from the conditioner's generator (`draws`); without a generator no noise
    is added, as JAX adds none without a key. `sigma_cond_config` raises, as
    in JAX."""

    draws = True

    def __init__(self, n_cond_frames: int, n_copies: int, encoder_config: Dict,
                 sigma_sampler_config: Optional[Dict] = None,
                 sigma_cond_config: Optional[Dict] = None, is_ae: bool = True,
                 scale_factor: float = 1.0, disable_encoder_autocast: bool = True,
                 en_and_decode_n_samples_a_time: Optional[int] = None):
        super().__init__()
        if sigma_cond_config is not None:
            raise NotImplementedError("sigma_cond not used by Hi3D")
        self.n_cond_frames = int(n_cond_frames)
        self.n_copies = int(n_copies)
        self.encoder = instantiate_from_config(encoder_config)
        self.sigma_sampler = (instantiate_from_config(sigma_sampler_config)
                              if sigma_sampler_config else None)
        self.scale_factor = float(scale_factor)
        self.en_chunk = en_and_decode_n_samples_a_time

    def draw(self, vid: torch.Tensor, generator: torch.Generator):
        """(σ of each video (B,), unit normals of `vid`'s shape)."""
        sigmas = self.sigma_sampler(vid.shape[0] // self.n_cond_frames, generator=generator,
                                    device=vid.device)
        return sigmas, torch.randn(vid.shape, generator=generator, device=vid.device,
                                   dtype=vid.dtype)

    def forward(self, vid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.sigma_sampler is not None and generator is not None:
            sigmas, noise = self.draw(vid, generator)
            sigmas = sigmas.repeat_interleave(self.n_cond_frames).to(vid.dtype)
            vid = vid + noise * sigmas.view(-1, *([1] * (vid.ndim - 1)))
        dtype = self.encoder.quant_conv.weight.dtype
        n = self.en_chunk or vid.shape[0]
        z = torch.cat([self.encoder.encode(vid[i:i + n].to(dtype))
                       for i in range(0, vid.shape[0], n)], dim=0).float()
        z = z * self.scale_factor
        bt, c, h, w = z.shape
        z = z.reshape(bt // self.n_cond_frames, self.n_cond_frames * c, h, w)
        return z.repeat_interleave(self.n_copies, dim=0)


class AesEmbedder(AbstractEmbedder):
    """Aesthetic-score vector: CLIP ViT-L/14 features of the middle frame →
    L2 normalise → MLP score → [score, sinusoidal(score·100, 255)] (B, 256)."""

    CLIP_PATH = "ckpts/ViT-L-14.pt"
    MLP_PATH = "ckpts/metric_models/sac+logos+ava1-l14-linearMSE.pth"

    def __init__(self, freeze: bool = True, clip_path: Optional[str] = None,
                 mlp_path: Optional[str] = None):
        super().__init__()
        self.clip = vit_l_14()
        self.mlp = AestheticMLP()
        clip_path = clip_path or self.CLIP_PATH
        mlp_path = mlp_path or self.MLP_PATH
        if os.path.exists(clip_path):
            _load_visual(self.clip, torch.jit.load(clip_path, map_location="cpu").state_dict())
        else:
            _tower_file_notice("CLIP ViT-L/14", clip_path)
        if os.path.exists(mlp_path):
            self.mlp.load_state_dict(torch.load(mlp_path, map_location="cpu", weights_only=True))
        else:
            _tower_file_notice("aesthetic MLP", mlp_path)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        frame = video[:, video.shape[1] // 2].float()
        y = resize_bilinear(frame, (224, 384))[:, :, :, 80:304]
        y = clip_normalize((y + 1.0) * 0.5)
        feats = self.clip(y)
        norm = feats.float().norm(dim=-1, keepdim=True)
        feats = feats / norm.clamp_min(1e-12).to(feats.dtype)
        score = self.mlp(feats.to(self.mlp.layers[0].weight.dtype)).float()
        emb = timestep_embedding(score[:, 0] * 100.0, 255)
        return torch.cat([score, emb], dim=-1)


class DepthEmbedder(AbstractEmbedder):
    """DPT-hybrid inverse depth of each conditioning frame, pixel-unshuffled
    to the latent grid (stage 2): frames (N, 3, H, W) or (B, T, 3, H, W) in
    [-1, 1] → (N, s², H/8, W/8) concat channels, s = shuffle_size.

    The frames are resized (bilinear, no antialias) to
    int(H/scale_factor/32)·32 (384 at 1024²), run through the fp32 DPT,
    resized to (H/8·s, W/8·s), min-max normalised per frame with a floor of
    1e-6, and unshuffled s×s → channels in (row offset, column offset) order,
    as the JAX embedder does. Its weights come from MODEL_PATH (the
    reference hard-codes it), not from the engine checkpoint, as in the JAX
    package; `model_kwargs` sizes the tower (tests)."""

    MODEL_PATH = "ckpts/dpt_hybrid_384.pt"
    loads_engine_checkpoint = False

    def __init__(self, freeze: bool = True, use_3d: bool = False, shuffle_size: int = 3,
                 scale_factor: float = 2.6666, model_kwargs: Optional[Dict] = None):
        super().__init__()
        if use_3d:
            raise NotImplementedError("use_3d depth is not used by Hi3D")
        self.shuffle_size = int(shuffle_size)
        self.scale_factor = float(scale_factor)
        self.model = DPTDepthModel(**(model_kwargs or {}))
        if os.path.exists(self.MODEL_PATH):
            from .convert import load_dpt_state_dict

            self.model.load_state_dict(load_dpt_state_dict(self.MODEL_PATH), strict=True)
        else:
            _tower_file_notice("DPT-hybrid", self.MODEL_PATH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 5:
            x = x.flatten(0, 1)
        _, _, hh, ww = x.shape
        s = self.shuffle_size
        size = (int(hh / self.scale_factor / 32) * 32, int(ww / self.scale_factor / 32) * 32)
        y = resize_bilinear(x.float(), size)
        y = self.model(y.to(self.model.pretrained.model.cls_token.dtype)).float()[:, None]
        y = resize_bilinear(y, (hh // 8 * s, ww // 8 * s))
        y = y - y.amin(dim=(1, 2, 3), keepdim=True)
        y = y / y.amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6)
        return F.pixel_unshuffle(y, s)


# --- the rest of sgm's embedder set (unused by the Hi3D configs) ------------


def _is_raw_text(text) -> bool:
    return isinstance(text, (list, tuple)) and bool(text) and isinstance(text[0], str)


def _refuse_raw_text(text, vocab: str) -> None:
    if _is_raw_text(text):
        raise NotImplementedError(f"raw-text tokenization needs {vocab} (not in the "
                                  "repository); pass token ids of shape (B, 77)")


class IdentityEncoder(AbstractEmbedder):
    """The batch value as the conditioning."""

    def forward(self, x):
        return torch.as_tensor(x)


class ClassEmbedder(AbstractEmbedder):
    """Learned class-label table (B,) → (B, embed_dim), or (B, 1, embed_dim)
    with `add_sequence_dim`; class n_classes − 1 is the unconditional one."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, add_sequence_dim: bool = False):
        super().__init__()
        self.n_classes = int(n_classes)
        self.add_sequence_dim = add_sequence_dim
        self.embedding = nn.Embedding(self.n_classes, int(embed_dim))
        nn.init.normal_(self.embedding.weight, std=0.02)

    def forward(self, c):
        emb = self.embedding(torch.as_tensor(c, device=self.embedding.weight.device).long())
        return emb[:, None, :] if self.add_sequence_dim else emb

    def get_unconditional_conditioning(self, bs: int, device=None) -> Dict[str, torch.Tensor]:
        return {self.input_key: torch.full((bs,), self.n_classes - 1, dtype=torch.long,
                                           device=device)}


class ClassEmbedderForMultiCond(ClassEmbedder):
    """ClassEmbedder of the first entry of a list-wrapped batch value,
    re-wrapped in a list."""

    def forward(self, c):
        if isinstance(c, list):
            return [super().forward(c[0])]
        return super().forward(c)


class SpatialRescaler(AbstractEmbedder):
    """n_stages resizes by `multiplier` with jax.image.resize's semantics
    ("nearest" with half-pixel centres; "bilinear"/"linear" and "bicubic"
    (Keys a = −0.5) antialiased when downscaling), then an optional k×k
    `channel_mapper` conv; `wrap_video` folds (B, T, C, H, W) into frames
    and back."""

    METHODS = {"nearest": "nearest", "linear": "bilinear", "bilinear": "bilinear",
               "bicubic": "cubic"}

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None, bias: bool = False,
                 wrap_video: bool = False, kernel_size: int = 1, remap_output: bool = False):
        super().__init__()
        if method not in self.METHODS:
            raise NotImplementedError(f"method {method!r}")
        self.n_stages = int(n_stages)
        self.method = self.METHODS[method]
        self.multiplier = float(multiplier)
        self.wrap_video = wrap_video
        self.channel_mapper = None
        if out_channels is not None or remap_output:
            if out_channels is None:
                raise ValueError("remap_output needs out_channels (as in the JAX package)")
            self.channel_mapper = nn.Conv2d(in_channels, out_channels, kernel_size, bias=bias,
                                            padding=kernel_size // 2)

    def forward(self, x):
        x = torch.as_tensor(x)
        video = x.shape[:2] if self.wrap_video and x.ndim == 5 else None
        if video is not None:
            x = x.flatten(0, 1)
        for _ in range(self.n_stages):
            h, w = x.shape[-2:]
            x = image_resize(x, (int(h * self.multiplier), int(w * self.multiplier)), self.method)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x)
        return x.unflatten(0, video) if video is not None else x


class FrozenOpenCLIPEmbedder(AbstractEmbedder):
    """OpenCLIP ViT-H/14 text tower on token ids (B, 77). `layer`: "last" =
    ln_final of the last block; "penultimate" = ln_final of the block
    before it; "pooled" = the projected EOT embedding (B, 1024).
    `always_return_pooled` returns (out, pooled). Weights: the text keys of
    the open_clip file `version` (the image embedder's file)."""

    LAYERS = ("last", "penultimate", "pooled")

    def __init__(self, arch: str = "ViT-H-14", version: Optional[str] = None,
                 max_length: int = 77, freeze: bool = True, layer: str = "last",
                 always_return_pooled: bool = False, legacy: bool = True, **_unused):
        super().__init__()
        if layer not in self.LAYERS:
            raise ValueError(f"layer {layer!r}")
        if arch != "ViT-H-14":
            raise NotImplementedError(f"arch {arch}")
        self.layer = layer
        self.max_length = int(max_length)
        self.return_pooled = always_return_pooled
        self.model = text_vit_h_14()
        if version and os.path.exists(version):
            from .convert import open_clip_text_state_dict

            self.model.load_state_dict(open_clip_text_state_dict(
                torch.load(version, map_location="cpu", weights_only=True)), strict=True)
        else:
            _tower_file_notice("OpenCLIP ViT-H-14 text", version)

    def forward(self, text):
        _refuse_raw_text(text, "open_clip's BPE vocabulary")
        ids = torch.as_tensor(text, device=self.model.positional_embedding.device)
        pooled, _, extras = self.model(ids)
        if self.layer == "pooled":
            out = pooled
        elif self.layer == "last":
            out = extras["final"]
        else:
            out = self.model.ln_final(extras["hidden"][-2])
        return (out, pooled) if self.return_pooled else out


class FrozenCLIPEmbedder(AbstractEmbedder):
    """OpenAI CLIP ViT-L/14 text tower on token ids (B, 77), with Hugging
    Face's outputs: "last" = the final-layer-normed sequence; "pooled" =
    that sequence at EOT, unprojected, with a length-1 sequence axis;
    "hidden" = hidden_states[layer_idx] (0 = the embeddings).
    `always_return_pooled` returns (out, EOT (B, 768)). Weights: the text
    keys of the OpenAI jit archive `version`, as the JAX package reads
    them; the names are open_clip's, not sgm's Hugging Face module's, so an
    engine checkpoint's keys do not load here."""

    LAYERS = ("last", "pooled", "hidden")
    loads_engine_checkpoint = False

    def __init__(self, version: str = "openai/clip-vit-large-patch14", max_length: int = 77,
                 freeze: bool = True, layer: str = "last", layer_idx: Optional[int] = None,
                 always_return_pooled: bool = False, **_unused):
        super().__init__()
        if layer not in self.LAYERS:
            raise ValueError(f"layer {layer!r}")
        if layer == "hidden" and (layer_idx is None or not 0 <= abs(layer_idx) <= 12):
            raise ValueError("layer='hidden' needs layer_idx in [-12, 12]")
        self.layer = layer
        self.layer_idx = layer_idx
        self.max_length = int(max_length)
        self.return_pooled = always_return_pooled
        self.transformer = text_vit_l_14()
        if version and os.path.exists(version):
            from .convert import load_checkpoint_file, open_clip_text_state_dict

            try:
                sd = torch.jit.load(version, map_location="cpu").state_dict()
            except RuntimeError:  # a plain state dict, as the JAX reader also takes
                sd = load_checkpoint_file(version)
            self.transformer.load_state_dict(open_clip_text_state_dict(sd), strict=True)
        else:
            _tower_file_notice("CLIP ViT-L/14 text", version)

    def forward(self, text):
        _refuse_raw_text(text, "the CLIP BPE vocabulary")
        ids = torch.as_tensor(text, device=self.transformer.positional_embedding.device)
        _, _, extras = self.transformer(ids)
        final = extras["final"]
        pooler = final[torch.arange(final.shape[0], device=final.device), ids.long().argmax(-1)]
        if self.layer == "last":
            out = final
        elif self.layer == "pooled":
            out = pooler[:, None, :]
        else:
            out = extras["hidden"][self.layer_idx]
        return (out, pooler) if self.return_pooled else out


class FrozenT5Embedder(AbstractEmbedder):
    """T5 encoder's last hidden state (B, L, d_model) of token ids, or of
    raw strings through the model directory's tokenizer where `transformers`
    imports. `version` names a local Hugging Face model directory, read at
    the first call (models.t5.load_t5_directory), as the JAX embedder loads
    at its first call; `transformer` may be set beforehand instead."""

    loads_engine_checkpoint = False

    def __init__(self, version: str = "google/t5-v1_1-xxl", max_length: int = 77,
                 freeze: bool = True, **_unused):
        super().__init__()
        self.version = version
        self.max_length = int(max_length)
        self.transformer: Optional[nn.Module] = None

    def encoder(self, device) -> nn.Module:
        if self.transformer is None:
            from .models.t5 import load_t5_directory

            self.transformer = load_t5_directory(self.version).to(device)
        return self.transformer

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        """(B, max_length) ids of raw strings by the directory's tokenizer;
        `transformers` is imported here and nowhere else in the package."""
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise NotImplementedError(
                "raw-text T5 tokenization needs the transformers package; pass token ids "
                "of shape (B, L)") from e
        tok = AutoTokenizer.from_pretrained(self.version)
        return tok(list(texts), truncation=True, max_length=self.max_length,
                   padding="max_length", return_tensors="np")["input_ids"]

    def forward(self, text):
        if _is_raw_text(text):
            text = self.tokenize(text)
        ids = text if torch.is_tensor(text) else torch.as_tensor(np.asarray(text))
        model = self.encoder(ids.device)
        return model(ids.to(model.shared.weight.device))


class FrozenByT5Embedder(FrozenT5Embedder):
    """ByT5: T5 on UTF-8 bytes, tokenized inline (byte + 3, EOS 1, PAD 0)."""

    def __init__(self, version: str = "google/byt5-base", max_length: int = 77,
                 freeze: bool = True, **_unused):
        super().__init__(version, max_length, freeze)

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        ids = np.zeros((len(texts), self.max_length), np.int32)  # pad = 0
        for i, t in enumerate(texts):
            raw = list(t.encode("utf-8"))[: self.max_length - 1]
            row = [b + 3 for b in raw] + [1]  # +3 special offset, eos = 1
            ids[i, : len(row)] = row
        return ids


class FrozenCLIPT5Encoder(AbstractEmbedder):
    """[CLIP ViT-L/14 "last" (B, 77, 768), T5 (B, L, d_model)]: a list, so
    both concatenate onto crossattn."""

    loads_engine_checkpoint = False

    def __init__(self, clip_version: str = "openai/clip-vit-large-patch14",
                 t5_version: str = "google/t5-v1_1-xl", clip_max_length: int = 77,
                 t5_max_length: int = 77, **_unused):
        super().__init__()
        self.clip_encoder = FrozenCLIPEmbedder(clip_version, max_length=clip_max_length)
        self.t5_encoder = FrozenT5Embedder(t5_version, max_length=t5_max_length)

    def forward(self, text):
        return [self.clip_encoder(text), self.t5_encoder(text)]


def _seeded(generator: Optional[torch.Generator], device) -> torch.Generator:
    """The given generator, or a fresh one seeded 0 on `device` (the JAX
    embedders draw from PRNGKey(0) when given no key)."""
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


class LowScaleEncoder(AbstractEmbedder):
    """First-stage encode (sampled from the generator) × scale_factor, then
    q_sample at a timestep t ∈ [0, max_noise_level) on the linear β
    schedule, then a nearest resize to output_size: [z, t (B, 1) fp32]."""

    draws = True

    def __init__(self, model_config: Dict, linear_start: float, linear_end: float,
                 timesteps: int = 1000, max_noise_level: int = 250,
                 output_size: Optional[int] = 64, scale_factor: float = 1.0, **_unused):
        super().__init__()
        from .diffusion.discretization import make_beta_schedule

        self.model = instantiate_from_config(model_config)
        self.max_noise_level = int(max_noise_level)
        self.out_size = output_size
        self.scale_factor = float(scale_factor)
        betas = make_beta_schedule("linear", timesteps, linear_start=linear_start,
                                   linear_end=linear_end)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        self.register_buffer("sqrt_alphas_cumprod",
                             torch.tensor(np.sqrt(alphas_cumprod), dtype=torch.float32),
                             persistent=False)
        self.register_buffer("sqrt_one_minus_alphas_cumprod",
                             torch.tensor(np.sqrt(1.0 - alphas_cumprod), dtype=torch.float32),
                             persistent=False)

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        a = append_dims(self.sqrt_alphas_cumprod[t], x0.ndim)
        s = append_dims(self.sqrt_one_minus_alphas_cumprod[t], x0.ndim)
        return a * x0 + s * noise

    def draw(self, z: torch.Tensor, generator: torch.Generator):
        """(t (B,), noise like z): the noise level and the q_sample noise."""
        t = torch.randint(0, self.max_noise_level, (z.shape[0],), generator=generator,
                          device=z.device)
        return t, torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        generator = _seeded(generator, x.device)
        z = self.model.encode(x, generator) * self.scale_factor
        t, noise = self.draw(z, generator)
        z = self.q_sample(z, t, noise)
        if self.out_size is not None:
            z = image_resize(z, (self.out_size, self.out_size), "nearest")
        return [z, t.float()[:, None]]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.model.decode(z / self.scale_factor)


class GaussianEncoder(Encoder, AbstractEmbedder):
    """A VAE Encoder (its parameters at the top level, as sgm's subclass
    has them) and a diagonal-Gaussian posterior sampled from the generator
    (its mode without one): (log {kl_loss, loss, weight}, z), z flattened
    to (B, h·w, C) tokens with `flatten_output`."""

    draws = True

    def __init__(self, weight: float = 1.0, flatten_output: bool = True, **ddkw):
        super().__init__(**ddkw)
        self.posterior = DiagonalGaussianRegularizer()
        self.weight = float(weight)
        self.flatten_output = flatten_output

    def forward(self, x, generator: Optional[torch.Generator] = None):
        z, log = self.posterior(Encoder.forward(self, x), generator)
        log = {**log, "loss": log["kl_loss"], "weight": self.weight}
        if self.flatten_output:
            z = z.flatten(2).transpose(1, 2)
        return log, z
