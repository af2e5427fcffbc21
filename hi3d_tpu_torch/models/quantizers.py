"""The VQ regularizers (counterpart of hi3d_tpu/models/quantizers.py).

sgm's `regularizers.quantize` family as `nn.Module`s on NCHW latents (the
reference's layout; 3-D inputs are (B, tokens, C) and ≤ 2-D inputs
(…, C)), each called as `regularizer(z, generator)` → `(z_q, log)`:
- `VectorQuantizer`: nearest codebook entry, the β commitment loss
  (`legacy`: β on the encoder term, as the JAX package computes it), the
  straight-through estimator, the optional `used` remap, perplexity;
- `GumbelQuantizer`: 1×1-conv logits, a Gumbel-softmax mix of the codebook
  (hard, straight-through, in training), the KL to the uniform prior;
- `EMAVectorQuantizer`: a codebook that follows exponential moving averages
  of the assignment counts and sums (`cluster_size`, `embed_avg`) instead of
  gradients, updated in training;
- `VectorQuantizerWithInputProjection`: linear projections into and out of
  the codebook space.
The remap's unknown indices are 'random' (drawn from `generator`; a
generator seeded with 0 when none is given, as the JAX package draws from
PRNGKey(0)), 'extra' (one more index) or a fixed int. Parameter names are
the reference's (`embedding.weight`, `proj.*`, `embed.weight`,
`embedding.cluster_size`, `embedding.embed_avg`, `proj_in.*`, `proj_out.*`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def measure_perplexity(indices: torch.Tensor, num_centroids: int):
    """(exp of the entropy of the empirical code distribution, the number of
    codes used)."""
    avg = F.one_hot(indices.reshape(-1), num_centroids).float().mean(dim=0)
    perplexity = torch.exp(-(avg * torch.log(avg + 1e-10)).sum())
    return perplexity, (avg > 0).sum()


def _channels_last(z: torch.Tensor) -> torch.Tensor:
    return z.permute(0, 2, 3, 1) if z.ndim == 4 else z


def _channels_back(z: torch.Tensor, ndim: int) -> torch.Tensor:
    return z.permute(0, 3, 1, 2) if ndim == 4 else z


def _nearest(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    d = ((z_flat ** 2).sum(dim=1, keepdim=True) + (codebook ** 2).sum(dim=1)
         - 2.0 * z_flat @ codebook.t())
    return d.argmin(dim=1)


class _Remap(nn.Module):
    """Index remapping through a `used` table (a .npy of code indices)."""

    def _setup_remap(self, remap: Optional[str], n: int,
                     unknown_index: Union[str, int]) -> None:
        self.remap = remap
        if remap is not None:
            self.register_buffer("used", torch.from_numpy(np.load(remap)).long(),
                                 persistent=False)
            self.re_embed = int(self.used.shape[0])
        else:
            self.used = None
            self.re_embed = n
        if unknown_index == "extra":
            self.unknown_index = self.re_embed
            self.re_embed += 1
        elif unknown_index == "random" or isinstance(unknown_index, int):
            self.unknown_index = unknown_index
        else:
            raise ValueError("unknown_index needs to be 'random', 'extra' or an int")

    def remap_to_used(self, inds: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        flat = inds.reshape(inds.shape[0], -1)
        match = (flat[:, :, None] == self.used[None, None, :]).long()
        new = match.argmax(dim=-1)
        unknown = match.sum(dim=2) < 1
        if self.unknown_index == "random":
            if generator is None:
                generator = torch.Generator(device=inds.device).manual_seed(0)
            fill = torch.randint(0, self.re_embed, new.shape, generator=generator,
                                 device=inds.device)
        else:
            fill = torch.full_like(new, self.unknown_index)
        return torch.where(unknown, fill, new).reshape(inds.shape)

    def unmap_to_all(self, inds: torch.Tensor) -> torch.Tensor:
        flat = inds.reshape(inds.shape[0], -1)
        if self.re_embed > self.used.shape[0]:  # the extra token → 0
            flat = torch.where(flat >= self.used.shape[0], torch.zeros_like(flat), flat)
        return self.used[flat].reshape(inds.shape)


class VectorQuantizer(_Remap):
    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, remap: Optional[str] = None,
                 unknown_index: Union[str, int] = "random", sane_index_shape: bool = False,
                 log_perplexity: bool = False, embedding_weight_norm: bool = False,
                 loss_key: str = "loss/vq", legacy: bool = True):
        super().__init__()
        if embedding_weight_norm:
            raise NotImplementedError("embedding_weight_norm (not in the JAX package either)")
        self.n_e, self.e_dim, self.beta = int(n_e), int(e_dim), float(beta)
        self.loss_key = loss_key
        self.sane_index_shape = sane_index_shape
        self.log_perplexity = log_perplexity
        self.legacy = legacy
        self.embedding = nn.Embedding(self.n_e, self.e_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / self.n_e, 1.0 / self.n_e)
        self._setup_remap(remap, self.n_e, unknown_index)

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None):
        if z.ndim > 4:
            raise ValueError("no reshaping strategy for inputs of more than 4 dims")
        zc = _channels_last(z)
        idx = _nearest(zc.reshape(-1, self.e_dim), self.embedding.weight)
        z_q = self.embedding(idx).reshape(zc.shape)
        log: Dict = {}
        if self.log_perplexity:
            perplexity, usage = measure_perplexity(idx.detach(), self.n_e)
            log.update({"perplexity": perplexity, "cluster_usage": usage})
        commit = ((z_q.detach() - zc) ** 2).mean()
        codebook = ((z_q - zc.detach()) ** 2).mean()
        log[self.loss_key] = (self.beta * commit + codebook if self.legacy
                              else commit + self.beta * codebook)
        z_q = zc + (z_q - zc).detach()  # straight-through
        if self.remap is not None:
            idx = self.remap_to_used(idx.reshape(z.shape[0], -1), generator).reshape(-1, 1)
        if self.sane_index_shape:
            idx = idx.reshape(zc.shape[:3]) if z.ndim == 4 else idx.reshape(zc.shape[0], -1)
        log["min_encoding_indices"] = idx
        return _channels_back(z_q, z.ndim), log

    def get_codebook_entry(self, indices: torch.Tensor,
                           shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """Codes of `indices`; with `shape` (B, H, W, C), NCHW latents."""
        if self.remap is not None:
            if shape is None:
                raise ValueError("get_codebook_entry needs shape with a remap")
            indices = self.unmap_to_all(indices.reshape(shape[0], -1)).reshape(-1)
        z_q = self.embedding(indices)
        if shape is not None:
            z_q = z_q.reshape(shape).permute(0, 3, 1, 2)
        return z_q


class GumbelQuantizer(_Remap):
    def __init__(self, num_hiddens: int, embedding_dim: int, n_embed: int,
                 straight_through: bool = True, kl_weight: float = 5e-4, temp_init: float = 1.0,
                 remap: Optional[str] = None, unknown_index: Union[str, int] = "random",
                 loss_key: str = "loss/vq"):
        super().__init__()
        self.loss_key = loss_key
        self.embedding_dim, self.n_embed = int(embedding_dim), int(n_embed)
        self.straight_through = straight_through
        self.temperature = float(temp_init)
        self.kl_weight = float(kl_weight)
        self.proj = nn.Conv2d(num_hiddens, self.n_embed, 1)
        self.embed = nn.Embedding(self.n_embed, self.embedding_dim)
        self._setup_remap(remap, self.n_embed, unknown_index)

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None,
                temp: Optional[float] = None, return_logits: bool = False, train: bool = True):
        """z (B, num_hiddens, H, W) → (B, embedding_dim, H, W); the Gumbel
        noise comes from `generator`."""
        hard = self.straight_through if train else True
        temp = self.temperature if temp is None else temp
        logits = self.proj(z)
        logits_used = logits[:, self.used] if self.remap is not None else logits
        u = torch.rand(logits_used.shape, generator=generator, device=z.device, dtype=z.dtype)
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        soft = F.softmax((logits_used + gumbel) / temp, dim=1)
        if hard:
            one_hot = F.one_hot(soft.argmax(dim=1), soft.shape[1]).permute(0, 3, 1, 2).to(soft)
            soft = soft + (one_hot - soft).detach()
        if self.remap is not None:
            full = torch.zeros_like(logits)
            full[:, self.used] = soft
            soft = full
        z_q = torch.einsum("bnhw,nd->bdhw", soft, self.embed.weight)
        qy = F.softmax(logits_used, dim=1)
        diff = self.kl_weight * (qy * torch.log(qy * self.n_embed + 1e-10)).sum(dim=1).mean()
        ind = soft.argmax(dim=1)
        log: Dict = {self.loss_key: diff, "indices": ind}
        if self.remap is not None:
            log["indices"] = self.remap_to_used(ind, generator)
        if return_logits:
            log["logits"] = logits_used
        return z_q, log

    def get_codebook_entry(self, indices: torch.Tensor, shape) -> torch.Tensor:
        """NCHW codes of `indices` for `shape` (B, H, W, C)."""
        b, h, w, _ = shape
        indices = indices.reshape(b, h, w)
        if self.remap is not None:
            indices = self.unmap_to_all(indices)
        one_hot = F.one_hot(indices, self.n_embed).to(self.embed.weight)
        return torch.einsum("bhwn,nd->bdhw", one_hot, self.embed.weight)


class EmbeddingEMA(nn.Module):
    """The EMA codebook's state: `weight`, `cluster_size`, `embed_avg`."""

    def __init__(self, num_tokens: int, codebook_dim: int):
        super().__init__()
        weight = torch.randn(num_tokens, codebook_dim)
        self.register_buffer("weight", weight)
        self.register_buffer("cluster_size", torch.zeros(num_tokens))
        self.register_buffer("embed_avg", weight.clone())


class EMAVectorQuantizer(_Remap):
    def __init__(self, n_embed: int, embedding_dim: int, beta: float, decay: float = 0.99,
                 eps: float = 1e-5, remap: Optional[str] = None,
                 unknown_index: Union[str, int] = "random", loss_key: str = "loss/vq"):
        super().__init__()
        self.codebook_dim, self.num_tokens = int(embedding_dim), int(n_embed)
        self.beta, self.decay, self.eps = float(beta), float(decay), float(eps)
        self.loss_key = loss_key
        self.embedding = EmbeddingEMA(self.num_tokens, self.codebook_dim)
        self.update = True
        self._setup_remap(remap, self.num_tokens, unknown_index)

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None,
                train: bool = True):
        """Quantise with the current codebook, then (training, `update`) move
        the codebook one EMA step towards this batch's assignments."""
        zc = _channels_last(z)
        z_flat = zc.reshape(-1, self.codebook_dim)
        weight = self.embedding.weight
        idx = _nearest(z_flat, weight)
        z_q = weight[idx].reshape(zc.shape)
        encodings = F.one_hot(idx, self.num_tokens).to(z.dtype)
        avg_probs = encodings.mean(dim=0)
        perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
        if train and self.update:
            self.apply_updates(*self.compute_updates(encodings, z_flat))
        loss = self.beta * ((z_q.detach() - zc) ** 2).mean()
        z_q = zc + (z_q - zc).detach()
        log = {self.loss_key: loss, "encodings": encodings, "encoding_indices": idx,
               "perplexity": perplexity}
        return _channels_back(z_q, z.ndim), log

    @torch.no_grad()
    def compute_updates(self, encodings: torch.Tensor, z_flat: torch.Tensor):
        """(cluster_size, embed_avg, weight) after one EMA step."""
        e = self.embedding
        cs = e.cluster_size * self.decay + (1 - self.decay) * encodings.sum(dim=0)
        avg = e.embed_avg * self.decay + (1 - self.decay) * (encodings.t() @ z_flat)
        n = cs.sum()
        smoothed = (cs + self.eps) / (n + self.num_tokens * self.eps) * n
        return cs, avg, avg / smoothed[:, None]

    @torch.no_grad()
    def apply_updates(self, cluster_size, embed_avg, weight) -> None:
        self.embedding.cluster_size.copy_(cluster_size)
        self.embedding.embed_avg.copy_(embed_avg)
        self.embedding.weight.copy_(weight)


class VectorQuantizerWithInputProjection(VectorQuantizer):
    def __init__(self, input_dim: int, n_codes: int, codebook_dim: int, beta: float = 1.0,
                 output_dim: Optional[int] = None, **kwargs):
        super().__init__(n_codes, codebook_dim, beta, **kwargs)
        self.proj_in = nn.Linear(input_dim, codebook_dim)
        self.output_dim = output_dim
        self.proj_out = (nn.Linear(codebook_dim, output_dim) if output_dim is not None
                         else nn.Identity())

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None):
        """z (B, C, …) → tokens (B, …, C) → codes; with `output_dim`, back to
        (B, output_dim, …)."""
        in_shape = z.shape
        if z.ndim > 3:
            z = z.flatten(2).transpose(1, 2)
        z_q, log = super().forward(self.proj_in(z), generator)
        z_q = self.proj_out(z_q)
        if self.output_dim is not None and len(in_shape) >= 4:
            z_q = z_q.transpose(1, 2).reshape(in_shape[0], self.output_dim, *in_shape[2:])
        return z_q, log
