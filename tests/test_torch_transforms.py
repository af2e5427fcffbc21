"""The port's cv2- and PIL-free transforms (hi3d_tpu_torch/data/transforms.py)
against the JAX package's cv2/PIL ones, case for case with
tests/test_transforms.py.

Tolerances: crops, flips, pads, LUT, gray, brightness/contrast/saturation
and hue exact; uint8 resizes and warps within 1 grey level (cv2 rounds
through fixed-point weights, or IPP's, where the port rounds once); float
within 1e-5, with cv2's IPP path off for the JAX side (IPP's float32
resampling is itself up to 1e-4 off cv2's own arithmetic, which the port
follows). Pipelines that normalise a uint8 resize: 2/255.
"""

import contextlib

import numpy as np
import pytest

import torch_threads  # noqa: F401
import cv2

import hi3d_tpu.data.transforms as J
import hi3d_tpu_torch.data.transforms as F

FLOAT_TOL = 1e-5


@contextlib.contextmanager
def no_ipp():
    prev = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(prev)


def rand_img(h=37, w=43, c=3, seed=0):
    shape = (h, w) if c is None else (h, w, c)
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def rand_float(h=37, w=43, c=3, seed=1):
    return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


def exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def close(got, want):
    """uint8 within one level, floats within FLOAT_TOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if want.dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


def _to_tensor_range_and_dtype():
    img = rand_img()
    exact(F.to_tensor(img), J.to_tensor(img))
    exact(F.to_tensor(img[..., 0]), J.to_tensor(img[..., 0]))
    exact(F.to_tensor(rand_float()), J.to_tensor(rand_float()))


def _center_crop_golden():
    img = np.arange(10 * 12).reshape(10, 12, 1)
    for size in ((4, 6), 5, (7, 3)):
        exact(F.center_crop(img, size), J.center_crop(img, size))


def _five_crop_corners_and_center():
    img = rand_img(32, 40)
    for a, b in zip(F.five_crop(img, 16), J.five_crop(img, 16)):
        exact(a, b)
    with pytest.raises(ValueError):
        F.five_crop(img, 41)


def _pad_and_flips():
    img = rand_img(4, 5)
    for padding, mode in (((2, 3), "constant"), (1, "reflect"), ((1, 2, 3, 4), "edge"),
                          (2, "symmetric")):
        exact(F.pad(img, padding, fill=7, padding_mode=mode),
              J.pad(img, padding, fill=7, padding_mode=mode))
    exact(F.hflip(img), J.hflip(img))
    exact(F.vflip(img), J.vflip(img))


def _resize_shorter_side_semantics():
    """Every interpolation, uint8 (3 channels, 1 channel as (H, W, 1) and
    (H, W)) and float32, down and up, int and (h, w) sizes."""
    for interp in ("nearest", "bilinear", "bicubic", "area", "lanczos"):
        for size in (20, (15, 25), 40, (61, 47), (40, 30), (20, 30)):
            for img in (rand_img(40, 60), rand_img(40, 60, 1), rand_img(40, 60, None)):
                close(F.resize(img, size, interp), J.resize(img, size, interp))
            img = rand_float(40, 60)
            with no_ipp():
                want = J.resize(img, size, interp)
            close(F.resize(img, size, interp), want)


def _rotate_expand():
    for angle in (90, 33.3, -170):
        for expand in (False, True):
            for img in (rand_img(20, 30), rand_img(20, 30, 1)):
                close(F.rotate(img, angle, expand), J.rotate(img, angle, expand))
            img = rand_float(20, 30)
            close(F.rotate(img, angle, expand), J.rotate(img, angle, expand))


def _adjust_brightness_golden():
    for f in (0.3, 1.5, 3.0):
        exact(F.adjust_brightness(rand_img(), f), J.adjust_brightness(rand_img(), f))
        exact(F.adjust_brightness(rand_float(), f), J.adjust_brightness(rand_float(), f))


def _adjust_contrast_golden():
    for f in (0.3, 1.7):
        exact(F.adjust_contrast(rand_img(), f), J.adjust_contrast(rand_img(), f))
        exact(F.adjust_contrast(rand_img(c=None), f), J.adjust_contrast(rand_img(c=None), f))


def _adjust_saturation_golden():
    for f in (0.0, 0.4, 2.0):
        exact(F.adjust_saturation(rand_img(), f), J.adjust_saturation(rand_img(), f))


def _normalize():
    img = F.to_tensor(rand_img())
    exact(F.normalize(img, [0.5, 0.4, 0.3], [0.2, 0.5, 0.7]),
          J.normalize(img, [0.5, 0.4, 0.3], [0.2, 0.5, 0.7]))


def _resized_crop():
    img = rand_img(30, 30)
    for interp in ("bilinear", "bicubic", "area"):
        close(F.resized_crop(img, 5, 5, 20, 20, (10, 10), interp),
              J.resized_crop(img, 5, 5, 20, 20, (10, 10), interp))


def _ten_crop():
    img = rand_img(32, 40)
    for vertical in (False, True):
        for a, b in zip(F.ten_crop(img, 16, vertical), J.ten_crop(img, 16, vertical)):
            exact(a, b)


def _adjust_hue_wraparound_and_identity():
    for f in (0.0, 0.5, -0.5, 0.13, -0.37):
        exact(F.adjust_hue(rand_img(16, 16), f), J.adjust_hue(rand_img(16, 16), f))
    exact(F.adjust_hue(rand_img(6, 5, 4), 0.2), J.adjust_hue(rand_img(6, 5, 4), 0.2))
    exact(F.adjust_hue(rand_img(6, 5, 1), 0.2), J.adjust_hue(rand_img(6, 5, 1), 0.2))
    with pytest.raises(ValueError):
        F.adjust_hue(rand_img(), 0.7)
    # PIL's two row conversions themselves, on every grey, the cube's
    # corners and edges and 2²⁰ random colours
    from PIL import Image

    rnd = np.random.RandomState(3)
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    edges = np.array([[r, g, b] for r in (0, 1, 254, 255) for g in range(0, 256, 17)
                      for b in (0, 128, 255)], np.uint8)
    rgb = np.concatenate([grey, edges, rnd.randint(0, 256, (1 << 20, 3)).astype(np.uint8)])
    img = rgb.reshape(1, -1, 3)
    want_hsv = np.array(Image.fromarray(img).convert("HSV"))
    exact(F.rgb_to_hsv(img), want_hsv)
    hsv = rnd.randint(0, 256, (1, 1 << 20, 3)).astype(np.uint8)
    exact(F.hsv_to_rgb(hsv), np.array(Image.fromarray(hsv, "HSV").convert("RGB")))


def _adjust_gamma_lut():
    for gamma, gain in ((1.0, 1), (2.0, 1), (0.4, 0.9)):
        exact(F.adjust_gamma(rand_img(8, 8), gamma, gain), J.adjust_gamma(rand_img(8, 8), gamma, gain))
    exact(F.adjust_gamma(rand_img(8, 8, 1), 0.5), J.adjust_gamma(rand_img(8, 8, 1), 0.5))
    with pytest.raises(ValueError):
        F.adjust_gamma(rand_img(), -1.0)


def _affine_identity_and_translate():
    """The JAX test's identity and shift, then every interpolation and
    border mode (with a fill colour) at a rotation, scale and shear."""
    img = rand_img(24, 24)
    exact(F.affine(img, angle=0, translate=(0, 0), scale=1.0, shear=0),
          J.affine(img, angle=0, translate=(0, 0), scale=1.0, shear=0))
    exact(F.affine(img, angle=0, translate=(3, 0), scale=1.0, shear=0),
          J.affine(img, angle=0, translate=(3, 0), scale=1.0, shear=0))
    for interp in ("nearest", "bilinear", "bicubic", "area"):
        for mode in ("constant", "replicate", "reflect", "reflect101"):
            args = dict(angle=21.0, translate=(3, -2), scale=1.3, shear=7.0,
                        interpolation=interp, mode=mode, fillcolor=(9, 200))
            for im in (rand_img(24, 29), rand_img(24, 29, 1)):
                close(F.affine(im, **args), J.affine(im, **args))
            args["fillcolor"] = (0.25, 0.75)  # a float image's fill in its own range
            close(F.affine(rand_float(24, 29), **args), J.affine(rand_float(24, 29), **args))
    with pytest.raises(ValueError):
        F.affine(img, 0, (0, 0), 0.0, 0)


def _to_grayscale():
    img = rand_img(8, 8)
    for n in (1, 3):
        exact(F.to_grayscale(img, n), J.to_grayscale(img, n))
    close(F.to_grayscale(rand_float(8, 8)), J.to_grayscale(rand_float(8, 8)))
    with pytest.raises(ValueError):
        F.to_grayscale(img, 2)


def _class_api_compose():
    def pipe(m):
        return m.Compose([m.Resize(20), m.CenterCrop(16), m.RandomHorizontalFlip(p=0.0),
                          m.ToTensor(), m.Normalize([0.5, 0.5, 0.5], [0.5, 0.5, 0.5])])

    got, want = pipe(F)(rand_img(40, 60)), pipe(J)(rand_img(40, 60))
    assert got.shape == want.shape == (16, 16, 3) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=2 / 255 + 1e-6)
    exact(F.Lambda(F.hflip)(rand_img()), J.Lambda(J.hflip)(rand_img()))


def _random_classes_deterministic_with_rng():
    """Each random class with the same seed in both packages: the same
    draws, so the same crops and warps; ColorJitter against JAX's functions
    applied in the drawn order with each op's own factor (the JAX class's
    closures all read the last factor drawn)."""
    img = rand_img(32, 32)
    g = np.random.default_rng
    exact(F.RandomCrop(16, padding=2, rng=g(7))(img), J.RandomCrop(16, padding=2, rng=g(7))(img))
    exact(F.RandomHorizontalFlip(rng=g(1))(img), J.RandomHorizontalFlip(rng=g(1))(img))
    exact(F.RandomVerticalFlip(rng=g(2))(img), J.RandomVerticalFlip(rng=g(2))(img))
    close(F.RandomResizedCrop(8, rng=g(3))(img), J.RandomResizedCrop(8, rng=g(3))(img))
    close(F.RandomRotation(10, rng=g(1))(img), J.RandomRotation(10, rng=g(1))(img))
    close(F.RandomAffine(5, translate=(0.1, 0.1), scale=(0.9, 1.1), shear=5, rng=g(2))(img),
          J.RandomAffine(5, translate=(0.1, 0.1), scale=(0.9, 1.1), shear=5, rng=g(2))(img))
    for a, b in zip(F.FiveCrop(10)(img), J.FiveCrop(10)(img)):
        exact(a, b)
    for a, b in zip(F.TenCrop(10)(img), J.TenCrop(10)(img)):
        exact(a, b)
    exact(F.Grayscale(3)(img), J.Grayscale(3)(img))
    exact(F.Pad(2, fill=3)(img), J.Pad(2, fill=3)(img))

    got = F.ColorJitter(0.2, 0.2, 0.2, 0.1, rng=g(4))(img)
    r = g(4)
    factors = [r.uniform(0.8, 1.2), r.uniform(0.8, 1.2), r.uniform(0.8, 1.2),
               r.uniform(-0.1, 0.1)]
    ops = [lambda im: J.adjust_brightness(im, factors[0]),
           lambda im: J.adjust_contrast(im, factors[1]),
           lambda im: J.adjust_saturation(im, factors[2]),
           lambda im: J.adjust_hue(im, factors[3])]
    r.shuffle(ops)
    want = img
    for op in ops:
        want = op(want)
    exact(got, want)


CASES = {f.__name__[1:]: f for f in (
    _to_tensor_range_and_dtype, _center_crop_golden, _five_crop_corners_and_center,
    _pad_and_flips, _resize_shorter_side_semantics, _rotate_expand, _adjust_brightness_golden,
    _adjust_contrast_golden, _adjust_saturation_golden, _normalize, _resized_crop, _ten_crop,
    _adjust_hue_wraparound_and_identity, _adjust_gamma_lut, _affine_identity_and_translate,
    _to_grayscale, _class_api_compose, _random_classes_deterministic_with_rng)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transform_matches_jax(case):
    """Each case of tests/test_transforms.py, port against JAX."""
    CASES[case]()


def test_gray_is_cv2_over_every_colour():
    """RGB2GRAY's 15-bit integer weights over all 2²⁴ colours."""
    allv = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
                    -1).astype(np.uint8).reshape(4096, 4096, 3)
    exact(F.to_grayscale(allv)[..., 0], cv2.cvtColor(allv, cv2.COLOR_RGB2GRAY))
