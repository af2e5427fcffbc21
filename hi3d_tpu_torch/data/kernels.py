"""Blur-kernel synthesis for the Real-ESRGAN degradation (numpy/scipy, on
the host in the data loader); the port's copy of hi3d_tpu/data/kernels.py.

The basicsr generators the reference imports (`random_mixed_kernels`,
`circular_lowpass_kernel`): bivariate (anisotropic) Gaussians, generalized
Gaussians exp(-½ (xᵀΣ⁻¹x)^β), plateaus 1/(1+(xᵀΣ⁻¹x)^β), and the circular
sinc low-pass ω·J₁(ω·r)/(2π·r). For the same `RandomState` the draws, their
order and the kernels are those of the JAX package, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import special

KERNEL_TYPES = (
    "iso", "aniso", "generalized_iso", "generalized_aniso",
    "plateau_iso", "plateau_aniso",
)


def _mesh_grid(kernel_size: int) -> np.ndarray:
    """(k, k, 2) grid of (x, y) offsets centred at 0."""
    ax = np.arange(-(kernel_size - 1) / 2.0, (kernel_size - 1) / 2.0 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1)


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0.0], [0.0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _quadratic_form(kernel_size: int, sig_x, sig_y, theta) -> np.ndarray:
    """xᵀ Σ⁻¹ x over the kernel grid."""
    grid = _mesh_grid(kernel_size)
    inv = np.linalg.inv(_sigma_matrix(sig_x, sig_y, theta))
    return np.einsum("hwi,ij,hwj->hw", grid, inv, grid)


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, isotropic=True):
    if isotropic:
        sig_y, theta = sig_x, 0.0
    k = np.exp(-0.5 * _quadratic_form(kernel_size, sig_x, sig_y, theta))
    return k / k.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, beta=1.0,
                                   isotropic=True):
    if isotropic:
        sig_y, theta = sig_x, 0.0
    k = np.exp(-0.5 * _quadratic_form(kernel_size, sig_x, sig_y, theta) ** beta)
    return k / k.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y=None, theta=0.0, beta=1.0, isotropic=True):
    if isotropic:
        sig_y, theta = sig_x, 0.0
    k = 1.0 / (_quadratic_form(kernel_size, sig_x, sig_y, theta) ** beta + 1.0)
    return k / k.sum()


def circular_lowpass_kernel(omega_c: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2-D sinc (circular low-pass) filter; kernel_size must be odd."""
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    grid = _mesh_grid(kernel_size)
    r = np.sqrt(grid[..., 0] ** 2 + grid[..., 1] ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = omega_c * special.j1(omega_c * r) / (2.0 * np.pi * r)
    mid = kernel_size // 2
    k[mid, mid] = omega_c**2 / (4.0 * np.pi)
    k = k / k.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        k = np.pad(k, ((pad, pad), (pad, pad)))
    return k


def random_mixed_kernels(
    kernel_list: Sequence[str],
    kernel_prob: Sequence[float],
    kernel_size: int,
    sigma_x_range: Tuple[float, float],
    sigma_y_range: Tuple[float, float],
    rotation_range: Tuple[float, float] = (-np.pi, np.pi),
    betag_range: Tuple[float, float] = (0.5, 4.0),
    betap_range: Tuple[float, float] = (1.0, 2.0),
    noise_range=None,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    rng = rng or np.random
    kind = rng.choice(list(kernel_list), p=list(kernel_prob))
    sx = rng.uniform(*sigma_x_range)
    sy = rng.uniform(*sigma_y_range)
    th = rng.uniform(*rotation_range)
    if kind == "iso":
        return bivariate_gaussian(kernel_size, sx, isotropic=True)
    if kind == "aniso":
        return bivariate_gaussian(kernel_size, sx, sy, th, isotropic=False)
    if kind == "generalized_iso":
        beta = rng.uniform(*betag_range)
        return bivariate_generalized_gaussian(kernel_size, sx, beta=beta, isotropic=True)
    if kind == "generalized_aniso":
        beta = rng.uniform(*betag_range)
        return bivariate_generalized_gaussian(kernel_size, sx, sy, th, beta=beta,
                                              isotropic=False)
    if kind == "plateau_iso":
        beta = rng.uniform(*betap_range)
        return bivariate_plateau(kernel_size, sx, beta=beta, isotropic=True)
    if kind == "plateau_aniso":
        beta = rng.uniform(*betap_range)
        return bivariate_plateau(kernel_size, sx, sy, th, beta=beta, isotropic=False)
    raise ValueError(f"unknown kernel type {kind!r}")


DEFAULT_DEGRADATION_OPT = {
    # reference configs/train_realesrnet_x4plus.yml (Real-ESRGAN defaults)
    "scale": 4,
    "resize_prob": [0.2, 0.7, 0.1],
    "resize_range": [0.15, 1.5],
    "gaussian_noise_prob": 0.5,
    "noise_range": [1, 30],
    "poisson_scale_range": [0.05, 3],
    "gray_noise_prob": 0.4,
    "jpeg_range": [30, 95],
    "second_blur_prob": 0.8,
    "resize_prob2": [0.3, 0.4, 0.3],
    "resize_range2": [0.3, 1.2],
    "gaussian_noise_prob2": 0.5,
    "noise_range2": [1, 25],
    "poisson_scale_range2": [0.05, 2.5],
    "gray_noise_prob2": 0.4,
    "jpeg_range2": [30, 95],
    "blur_kernel_size": 21,
    "kernel_list": list(KERNEL_TYPES),
    "kernel_prob": [0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
    "sinc_prob": 0.1,
    "blur_sigma": [0.2, 3],
    "betag_range": [0.5, 4],
    "betap_range": [1, 2],
    "blur_kernel_size2": 21,
    "kernel_list2": list(KERNEL_TYPES),
    "kernel_prob2": [0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
    "sinc_prob2": 0.1,
    "blur_sigma2": [0.2, 1.5],
    "betag_range2": [0.5, 4],
    "betap_range2": [1, 2],
    "final_sinc_prob": 0.8,
}

KERNEL_RANGE = [2 * v + 1 for v in range(3, 11)]  # 7..21 odd


def pulse_kernel(size: int = 21) -> np.ndarray:
    k = np.zeros((size, size), np.float32)
    k[size // 2, size // 2] = 1.0
    return k


def sample_frame_kernels(
    opt: dict, num_frames: int, rng: Optional[np.random.RandomState] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame (kernel1s, kernel2s, sinc_kernels), each (T, 21, 21) float32
    (reference video_dataset_stage2_degradeImages.py:184-251)."""
    rng = rng or np.random
    k1s, k2s, sincs = [], [], []
    for _ in range(num_frames):
        for (sinc_p, klist, kprob, sigma, bg, bp), acc in (
            ((opt["sinc_prob"], opt["kernel_list"], opt["kernel_prob"],
              opt["blur_sigma"], opt["betag_range"], opt["betap_range"]), k1s),
            ((opt["sinc_prob2"], opt["kernel_list2"], opt["kernel_prob2"],
              opt["blur_sigma2"], opt["betag_range2"], opt["betap_range2"]), k2s),
        ):
            size = int(rng.choice(KERNEL_RANGE))
            if rng.uniform() < sinc_p:
                lo = np.pi / 3 if size < 13 else np.pi / 5
                k = circular_lowpass_kernel(rng.uniform(lo, np.pi), size, pad_to=0)
            else:
                k = random_mixed_kernels(klist, kprob, size, sigma, sigma, (-np.pi, np.pi),
                                         bg, bp, rng=rng)
            pad = (21 - size) // 2
            acc.append(np.pad(k, ((pad, pad), (pad, pad))))
        if rng.uniform() < opt["final_sinc_prob"]:
            size = int(rng.choice(KERNEL_RANGE))
            omega = rng.uniform(np.pi / 3, np.pi)
            sincs.append(circular_lowpass_kernel(omega, size, pad_to=21))
        else:
            sincs.append(pulse_kernel(21))
    return (np.asarray(k1s, np.float32), np.asarray(k2s, np.float32),
            np.asarray(sincs, np.float32))
