"""Encoder propagation ("turbo") sampling (counterpart of
hi3d_tpu/diffusion/encoder_reuse.py; Faster Diffusion, arXiv 2312.09608).

The UNet's input and middle block activations change little between
adjacent sampler steps, so a step may skip them and decode from an earlier
step's cached (skip activations, middle h). The EDM samplers' loop and the
stage-2 blend loop keep the cache; it starts as None and step 0 always
refreshes it."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple


def reuse_flags(n: int, k: int) -> List[bool]:
    """n flags, True where the step may DECODE FROM THE CACHE: the encoder
    runs on every k-th step (i % k == 0, so step 0 always computes fully)
    and on the last step (the final σ → 0 update sees fresh features)."""
    k = int(k)
    return [i % k != 0 and i != n - 1 for i in range(n)]


def step_denoiser(dfn: Callable, cache) -> Tuple[Callable, Dict]:
    """Bind the cached denoiser form `dfn(x, σ, cond, cache) → (denoised,
    cache)` for one sampler step: `den(x, σ, cond)` and a cell whose
    "cache" holds the cache after the step. With `cache` None every forward
    of the step runs the whole UNet and the cell keeps the LAST forward's
    cache (Heun's correction denoise, where the step has one); with a cache
    every forward decodes from it."""
    cell = {"cache": cache}

    def den(x, sigma, cond):
        out, cell["cache"] = dfn(x, sigma, cond, cache)
        return out

    return den, cell
