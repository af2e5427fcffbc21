"""Conditioning: GeneralConditioner and the stage-1 and stage-2 embedders
(counterpart of hi3d_tpu/conditioners.py).

NCHW throughout: frames are (N, 3, H, W) and videos (B, T, 3, H, W) in
[-1, 1]. Outputs route by rank into {vector (B, D), crossattn (B, S, C),
concat (B, C, h, w)} and concatenate along the reference's dims (1, 2, 1).
The towers load their released files when present and otherwise keep a
random initialisation, with a printed notice.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import instantiate_from_config
from .models.clip import (
    AestheticMLP,
    clip_normalize,
    resize_bicubic,
    resize_bilinear,
    vit_h_14,
    vit_l_14,
)
from .models.dpt import DPTDepthModel
from .models.layers import timestep_embedding
from .utils.misc import append_dims

CondDict = Dict[str, torch.Tensor]


def _tower_file_notice(name: str, path: Optional[str]) -> None:
    print(f"[conditioner] {name}: weight file {path!r} not found — random init")


def _load_visual(tower: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    visual = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    tower.load_state_dict(visual, strict=True)


class AbstractEmbedder(nn.Module):
    """An embedder computes one conditioning tensor from one batch key."""

    OUT_KEY_BY_NDIM = {2: "vector", 3: "crossattn", 4: "concat"}
    # whether an engine checkpoint's `conditioner.embedders.N.*` keys load here
    loads_engine_checkpoint = True

    def __init__(self):
        super().__init__()
        self.input_key: Optional[str] = None
        self.ucg_rate = 0.0


class GeneralConditioner(nn.Module):
    CAT_DIM = {"vector": 1, "crossattn": 2, "concat": 1}

    def __init__(self, emb_models: Sequence[Dict]):
        super().__init__()
        self.embedders = nn.ModuleList()
        for n, cfg in enumerate(emb_models):
            emb = instantiate_from_config(cfg)
            if not isinstance(emb, AbstractEmbedder):
                raise TypeError(f"embedder {type(emb).__name__} must inherit AbstractEmbedder")
            if "input_key" not in cfg:
                raise KeyError(f"embedder #{n} needs 'input_key'")
            emb.input_key = cfg["input_key"]
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
        embedder's output per sample with probability ucg_rate (training-time
        CFG dropout)."""
        force_zero = force_zero_embeddings or []
        out: CondDict = {}
        pinned = self.parity_ucg_keep
        for n, emb_mod in enumerate(self.embedders):
            emb = emb_mod(batch[emb_mod.input_key])
            key = AbstractEmbedder.OUT_KEY_BY_NDIM[emb.ndim]
            if ucg_enabled and emb_mod.ucg_rate > 0.0 and (generator is not None or pinned is not None):
                if pinned is not None:
                    keep = torch.as_tensor(pinned[n], dtype=torch.float32, device=emb.device)
                else:
                    keep = torch.bernoulli(
                        torch.full((emb.shape[0],), 1.0 - emb_mod.ucg_rate, device=emb.device),
                        generator=generator,
                    )
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
            emb = emb_mod(batch_c[emb_mod.input_key])
            key = AbstractEmbedder.OUT_KEY_BY_NDIM[emb.ndim]
            for out, forced in ((c, force_c), (uc, force_uc)):
                self._add(out, key, torch.zeros_like(emb) if emb_mod.input_key in forced else emb)
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
    (B·n_copies, n_cond_frames·C, h, w), frame-major channel packing."""

    def __init__(self, n_cond_frames: int, n_copies: int, encoder_config: Dict,
                 sigma_sampler_config: Optional[Dict] = None,
                 sigma_cond_config: Optional[Dict] = None, is_ae: bool = True,
                 scale_factor: float = 1.0, disable_encoder_autocast: bool = True,
                 en_and_decode_n_samples_a_time: Optional[int] = None):
        super().__init__()
        if sigma_sampler_config is not None or sigma_cond_config is not None:
            raise NotImplementedError("sigma_sampler/sigma_cond are training-slice options")
        self.n_cond_frames = int(n_cond_frames)
        self.n_copies = int(n_copies)
        self.encoder = instantiate_from_config(encoder_config)
        self.scale_factor = float(scale_factor)
        self.en_chunk = en_and_decode_n_samples_a_time

    def forward(self, vid: torch.Tensor) -> torch.Tensor:
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
