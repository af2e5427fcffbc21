"""Diffusion samplers (counterpart of hi3d_tpu/diffusion/samplers.py) as plain
Python loops over the σ schedule.

The schedule is float32 numpy on the host (the discretization's
`get_sigmas` with σ = 0 appended), so every branch on σ is taken in Python
without a device sync, and each step's σ becomes a (B,) float32 tensor on
x's device. Where the JAX scan computes a σ = 0 branch and discards it with
`jnp.where` (Heun's correction on the last step, DPM++(2S)'s midpoint when
σ_down = 0, ancestral noise when σ_next = 0), the port skips it, as the
reference sgm does; the result is the same and the UNet is called once less.
Scalar σ-math is float32 numpy, each coefficient cast to x's dtype at the
multiply.

The denoiser is `denoiser(x, sigma, cond) -> denoised`; with
`encoder_reuse` the EDM family takes the cached form `denoiser(x, sigma,
cond, cache) -> (denoised, cache)` (engine.DiffusionEngine.sample). Every
random draw of a sampler (churn, ancestral noise) goes through `_noise`.
`steps_per_launch` is accepted for YAML parity and ignored: in the JAX
package it splits the jitted scan for the XLA compile cache.

Within `use_frames(frames)` (a `parallel.dist.FrameShard`) x holds only
this rank's rows of the batch: each draw takes the whole batch's numbers
from the generator and keeps the rank's rows, as one process would draw
them, and the guider scales each row by its own frame."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import instantiate_from_config
from ..utils.misc import append_dims, default
from .encoder_reuse import reuse_flags, step_denoiser

DEFAULT_GUIDER = {"target": "sgm.modules.diffusionmodules.guiders.IdentityGuider"}

_F32 = np.float32
_SIGMA_EPS = _F32(1e-20)  # clamp of σ = 0 before a log, as in the JAX package


def _flag_segments(flags):
    """Split [0, len(flags)) into (start, end, flag) runs of constant flag."""
    n = len(flags)
    runs = []
    s0 = 0
    for i in range(1, n + 1):
        if i == n or bool(flags[i]) != bool(flags[s0]):
            runs.append((s0, i, bool(flags[s0])))
            s0 = i
    return runs


def cfg_flags(sigmas: np.ndarray, cfg_interval=None, encoder_reuse: int = 0) -> np.ndarray:
    """(n,) bool: the steps of the host schedule `sigmas` (σ = 0 appended)
    that run CFG — all of them, or with `cfg_interval=(lo, hi)` those whose
    float32 σ_i lies in [lo, hi]. The interval excludes encoder reuse: the
    encoder cache's batch differs between CFG-doubled and single-pass steps."""
    if cfg_interval is None:
        return np.ones(len(sigmas) - 1, bool)
    if encoder_reuse:
        raise ValueError(
            "cfg_interval and encoder_reuse are mutually exclusive (the encoder cache's batch "
            "dim differs between CFG-doubled and single-pass steps)")
    lo, hi = cfg_interval
    return (sigmas[:-1] >= lo) & (sigmas[:-1] <= hi)


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    """ODE derivative dx/dσ = (x − D(x, σ)) / σ."""
    return (x - denoised) / append_dims(sigma, x.ndim)


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """(σ_down, σ_up) of an ancestral step, on float32 numpy values."""
    sigma_from, sigma_to = _F32(sigma_from), _F32(sigma_to)
    if not eta:
        return sigma_to, np.zeros_like(sigma_to)
    sigma_up = np.minimum(sigma_to, _F32(eta) * np.sqrt(
        sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2))
    sigma_down = np.sqrt(sigma_to**2 - sigma_up**2)
    return sigma_down, sigma_up


class BaseDiffusionSampler:
    frames = None  # the FrameShard of the rows x holds (`use_frames`), or None: every row

    def __init__(self, discretization_config: Dict, num_steps: Optional[int] = None,
                 guider_config: Optional[Dict] = None, verbose: bool = False,
                 device: Optional[str] = None, steps_per_launch: Optional[int] = None):
        self.num_steps = num_steps
        self.discretization = instantiate_from_config(discretization_config)
        self.guider = instantiate_from_config(default(guider_config, DEFAULT_GUIDER))

    def schedule(self, num_steps: Optional[int] = None) -> np.ndarray:
        """(num_steps + 1,) float32 σ on the host, σ = 0 appended."""
        return np.append(self.discretization.get_sigmas(default(num_steps, self.num_steps)),
                         _F32(0.0))

    def prepare_sampling_loop(self, x, cond, uc=None, num_steps=None):
        sigmas = self.schedule(num_steps)
        # unit-variance noise lifted onto the σ₀ shell
        sigma0 = torch.tensor(sigmas[0], device=x.device)
        x = x * torch.sqrt(1.0 + sigma0**2.0).to(x.dtype)
        return x, sigmas, cond, default(uc, cond)

    @staticmethod
    def _sigma(x: torch.Tensor, value) -> torch.Tensor:
        """A host σ as a (B,) float32 tensor on x's device."""
        return torch.full((x.shape[0],), float(value), dtype=torch.float32, device=x.device)

    def _coef(self, x: torch.Tensor, value) -> torch.Tensor:
        """A host coefficient broadcast against x, in x's dtype."""
        return append_dims(self._sigma(x, value), x.ndim).to(x.dtype)

    @contextlib.contextmanager
    def use_frames(self, frames):
        """Within: x holds the rows of `frames` (a FrameShard) alone."""
        self.frames = frames
        try:
            yield
        finally:
            del self.frames

    def _noise(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Every random draw of a sampler: unit normal noise of x's shape and
        dtype (this rank's rows of the whole batch's draw within
        `use_frames`)."""
        if self.frames is not None:
            return self.frames.randn((self.frames.total,) + tuple(x.shape[1:]), generator,
                                     x.device, x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def denoise(self, x, denoiser, sigma, cond, uc, use_cfg: bool = True):
        if not use_cfg:
            # guidance interval: one conditioned pass, no batch doubling, the
            # guider bypassed (≡ CFG scale 1 at this step)
            return denoiser(x, sigma, cond)
        x_in, sigma_in, cond_in = self.guider.prepare_inputs(x, sigma, cond, uc)
        return self.guider(denoiser(x_in, sigma_in, cond_in), sigma, frames=self.frames)


class SingleStepDiffusionSampler(BaseDiffusionSampler):
    def euler_step(self, x, d, dt):
        return x + dt * d


class EDMSampler(SingleStepDiffusionSampler):
    """Euler/Heun family with optional stochastic churn (Karras Alg. 2)."""

    def __init__(self, s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = float("inf"),
                 s_noise: float = 1.0, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.s_churn = float(s_churn)
        self.s_tmin = float(s_tmin)
        self.s_tmax = float(s_tmax)
        self.s_noise = float(s_noise)

    def _gammas(self, sigmas: np.ndarray) -> np.ndarray:
        """(n,) float32 γ_i of the host schedule: the capped churn inside
        [s_tmin, s_tmax], 0 elsewhere."""
        n = len(sigmas) - 1
        gamma_val = min(self.s_churn / (n if n > 0 else 1), 2**0.5 - 1)
        in_range = (sigmas[:-1] >= self.s_tmin) & (sigmas[:-1] <= self.s_tmax)
        return np.where(in_range, _F32(gamma_val), _F32(0.0))

    def sampler_step(self, sigma, next_sigma, denoiser, x, cond, uc=None, gamma=0.0,
                     generator: Optional[torch.Generator] = None, use_cfg: bool = True):
        """One step from host σ to host next σ."""
        sigma_hat = _F32(_F32(sigma) * (_F32(gamma) + _F32(1.0)))
        s_hat = self._sigma(x, sigma_hat)
        if self.s_churn > 0.0:
            if generator is None:
                raise ValueError("churn sampling (s_churn>0) requires a generator")
            if gamma > 0:
                s = self._sigma(x, sigma)
                eps = self._noise(x, generator) * self.s_noise
                x = x + eps * append_dims(
                    torch.sqrt(torch.clamp(s_hat**2 - s**2, min=0.0)), x.ndim).to(x.dtype)
        denoised = self.denoise(x, denoiser, s_hat, cond, uc, use_cfg)
        d = to_d(x, s_hat, denoised)
        dt = append_dims(self._sigma(x, next_sigma) - s_hat, x.ndim)
        euler_step = self.euler_step(x, d.to(x.dtype), dt.to(x.dtype))
        return self.possible_correction_step(euler_step, x, d, dt, next_sigma, denoiser, cond,
                                             uc, use_cfg)

    def step_call(self, denoiser, x, i: int, sigmas: np.ndarray, cond, uc,
                  generator: Optional[torch.Generator] = None, use_cfg: bool = True):
        """Step `i` of the host schedule `sigmas` (`schedule`), driven from
        outside: the stage-2 blend loop changes x between steps."""
        return self.sampler_step(sigmas[i], sigmas[i + 1], denoiser, x, cond, uc,
                                 self._gammas(sigmas)[i], generator, use_cfg)

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Dict,
                 uc: Optional[Dict] = None, num_steps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, encoder_reuse: int = 0,
                 cfg_interval=None) -> torch.Tensor:
        """Full sampling loop.

        `encoder_reuse=k` (k ≥ 1): the UNet encoder and middle block run on
        every k-th step and the last (`reuse_flags`); the other steps decode
        from the cache of the previous full step. `denoiser` is then the
        cached form. k = 1 is the exact path's math; k ≥ 2 approximates.

        `cfg_interval=(lo, hi)`: CFG only on steps whose float32 σ_i lies in
        [lo, hi]; elsewhere one conditioned pass (half the UNet batch). An
        interval covering the schedule equals the exact path; a narrower
        one approximates. The two modes are exclusive: the cache's batch
        differs between CFG-doubled and single-pass steps."""
        x, sigmas, cond, uc = self.prepare_sampling_loop(x, cond, uc, num_steps)
        n = len(sigmas) - 1
        gammas = self._gammas(sigmas)
        if self.s_churn > 0.0 and generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        cfg_on = cfg_flags(sigmas, cfg_interval, encoder_reuse)
        reuse = reuse_flags(n, encoder_reuse) if encoder_reuse else None
        cache = None
        for s0, s1, use_cfg in _flag_segments(cfg_on):
            for i in range(s0, s1):
                den = denoiser
                if reuse is not None:
                    den, cell = step_denoiser(denoiser, cache if reuse[i] else None)
                x = self.sampler_step(sigmas[i], sigmas[i + 1], den, x, cond, uc, gammas[i],
                                      generator, use_cfg)
                if reuse is not None:
                    cache = cell["cache"]
        return x


class EulerEDMSampler(EDMSampler):
    def possible_correction_step(self, euler_step, x, d, dt, next_sigma, denoiser, cond, uc,
                                 use_cfg: bool = True):
        return euler_step


class HeunEDMSampler(EDMSampler):
    def possible_correction_step(self, euler_step, x, d, dt, next_sigma, denoiser, cond, uc,
                                 use_cfg: bool = True):
        if not next_sigma > 0:  # the last step: no correction
            return euler_step
        s_next = self._sigma(x, next_sigma)
        denoised = self.denoise(euler_step, denoiser, s_next, cond, uc, use_cfg)
        d_new = to_d(euler_step, s_next, denoised)
        d_prime = (d + d_new) / 2.0
        return x + (d_prime * dt).to(x.dtype)


class AncestralSampler(SingleStepDiffusionSampler):
    def __init__(self, eta: float = 1.0, s_noise: float = 1.0, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.eta = float(eta)
        self.s_noise = float(s_noise)

    def ancestral_euler_step(self, x, denoised, sigma, sigma_down):
        """Euler step from host σ to host σ_down."""
        s = self._sigma(x, sigma)
        d = to_d(x, s, denoised)
        dt = append_dims(self._sigma(x, sigma_down) - s, x.ndim)
        return self.euler_step(x, d.to(x.dtype), dt.to(x.dtype))

    def ancestral_step(self, x, next_sigma, sigma_up, generator):
        if not next_sigma > 0:  # σ_up is 0 on the last step
            return x
        noise = self._noise(x, generator) * self.s_noise
        return x + noise * self._coef(x, sigma_up)

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Dict,
                 uc: Optional[Dict] = None, num_steps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, sigmas, cond, uc = self.prepare_sampling_loop(x, cond, uc, num_steps)
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        for i in range(len(sigmas) - 1):
            x = self.sampler_step(sigmas[i], sigmas[i + 1], denoiser, x, cond, uc, generator)
        return x


class EulerAncestralSampler(AncestralSampler):
    def sampler_step(self, sigma, next_sigma, denoiser, x, cond, uc, generator):
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta=self.eta)
        denoised = self.denoise(x, denoiser, self._sigma(x, sigma), cond, uc)
        x = self.ancestral_euler_step(x, denoised, sigma, sigma_down)
        return self.ancestral_step(x, next_sigma, sigma_up, generator)


class DPMPP2SAncestralSampler(AncestralSampler):
    """DPM-Solver++(2S) with ancestral noise; the midpoint evaluation only
    where σ_down > 0 (an Euler step to σ_down elsewhere)."""

    def sampler_step(self, sigma, next_sigma, denoiser, x, cond, uc, generator):
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta=self.eta)
        denoised = self.denoise(x, denoiser, self._sigma(x, sigma), cond, uc)
        if not sigma_down > 0:
            x = self.ancestral_euler_step(x, denoised, sigma, sigma_down)
            return self.ancestral_step(x, next_sigma, sigma_up, generator)
        t, t_next = -np.log(_F32(sigma)), -np.log(sigma_down)
        h = t_next - t
        s = t + _F32(0.5) * h
        x2 = (self._coef(x, np.exp(-s) / np.exp(-t)) * x
              - self._coef(x, np.expm1(_F32(-0.5) * h)) * denoised.to(x.dtype))
        denoised2 = self.denoise(x2, denoiser, self._sigma(x, np.exp(-s)), cond, uc)
        x = (self._coef(x, np.exp(-t_next) / np.exp(-t)) * x
             - self._coef(x, np.expm1(-h)) * denoised2.to(x.dtype))
        return self.ancestral_step(x, next_sigma, sigma_up, generator)


class LinearMultistepSampler(BaseDiffusionSampler):
    """Linear multistep (Adams–Bashforth in σ): the coefficients depend only
    on the host schedule and come from scipy.integrate, as the JAX package's
    `_coeff_matrix` computes them; the derivative history is newest first."""

    def __init__(self, order: int = 4, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.order = int(order)

    def _coeff_matrix(self, sigmas_np: np.ndarray) -> np.ndarray:
        from scipy import integrate

        n = len(sigmas_np) - 1
        coeffs = np.zeros((n, self.order), np.float32)
        for i in range(n):
            cur = min(i + 1, self.order)
            for j in range(cur):
                def fn(tau, j=j, cur=cur):
                    prod = 1.0
                    for k in range(cur):
                        if j == k:
                            continue
                        prod *= (tau - sigmas_np[i - k]) / (sigmas_np[i - j] - sigmas_np[i - k])
                    return prod

                coeffs[i, j] = integrate.quad(fn, sigmas_np[i], sigmas_np[i + 1], epsrel=1e-4)[0]
        return coeffs

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Dict,
                 uc: Optional[Dict] = None, num_steps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, sigmas, cond, uc = self.prepare_sampling_loop(x, cond, uc, num_steps)
        coeffs = torch.as_tensor(self._coeff_matrix(sigmas), device=x.device).to(x.dtype)
        ds = []
        for i in range(len(sigmas) - 1):
            s = self._sigma(x, sigmas[i])
            denoised = self.denoise(x, denoiser, s, cond, uc)
            ds = [to_d(x, s, denoised).to(x.dtype)] + ds[:self.order - 1]
            x = x + torch.tensordot(coeffs[i, :len(ds)], torch.stack(ds), dims=1)
        return x


class DPMPP2MSampler(BaseDiffusionSampler):
    """DPM-Solver++(2M): deterministic multistep in log-σ time."""

    def sampler_step(self, old_denoised, previous_sigma, sigma, next_sigma, denoiser, x, cond,
                     uc=None, is_first: bool = False):
        denoised = self.denoise(x, denoiser, self._sigma(x, sigma), cond, uc).to(x.dtype)
        safe_next = np.maximum(_F32(next_sigma), _SIGMA_EPS)
        t, t_next = -np.log(_F32(sigma)), -np.log(safe_next)
        h = t_next - t
        mult1 = self._coef(x, safe_next / _F32(sigma))
        mult2 = self._coef(x, np.expm1(-h))
        # first step, or the final σ = 0: the first-order update
        if is_first or np.full(x.shape[0], next_sigma, np.float32).sum() < 1e-14:
            return mult1 * x - mult2 * denoised, denoised
        h_last = t - (-np.log(np.maximum(_F32(previous_sigma), _SIGMA_EPS)))
        r = h_last / h
        denoised_d = (self._coef(x, _F32(1) + _F32(1) / (_F32(2) * r)) * denoised
                      - self._coef(x, _F32(1) / (_F32(2) * r)) * old_denoised)
        return mult1 * x - mult2 * denoised_d, denoised

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Dict,
                 uc: Optional[Dict] = None, num_steps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, sigmas, cond, uc = self.prepare_sampling_loop(x, cond, uc, num_steps)
        old_denoised = torch.zeros_like(x)
        for i in range(len(sigmas) - 1):
            x, old_denoised = self.sampler_step(
                old_denoised, sigmas[max(i - 1, 0)], sigmas[i], sigmas[i + 1], denoiser, x,
                cond, uc=uc, is_first=i == 0)
        return x
