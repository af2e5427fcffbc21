"""The turbo modes of stage 1 (`--encoder_reuse`, `--cfg_interval`) against
hi3d_tpu on CPU, in fp32, on the tiny stage-1 engines of
tests/test_torch_slice.py (shared weights, the same noise and pinned
conditioning noise): the UNet's encoder cache, `generate_orbit`,
`engine.sample`'s checks, `OrbitServer` against the JAX package's
`generate_orbit` per asset, and the four CLIs' flags (the stage-2 blend
loop in tests/test_torch_turbo_stage2.py).

Tolerances: the exact-path tolerances of tests/test_torch_slice.py — 2e-3
absolute on decoded frames (fp32 in both packages, different summation
orders, latents at σ_max = 700 scale through the first steps), 1e-4 of the
largest magnitude for one UNet call. The port's own k = 1 and full-cover
runs equal its exact path exactly: they run the same operations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import yaml

from test_torch_slice import ATOL, RES, T, models, tiny_config  # noqa: F401  (module fixture)

UNET_RTOL = 1e-4


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _cond(seed):
    rnd = np.random.RandomState(seed)
    h = RES // 8
    x = rnd.randn(T, h, h, 4).astype(np.float32)
    sigma = np.full((T,), 3.7, np.float32)
    c = {"vector": rnd.randn(1, 32).astype(np.float32),
         "crossattn": rnd.randn(1, 1, 32).astype(np.float32),
         "concat": rnd.randn(T, h, h, 4).astype(np.float32)}
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    tc = {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 1)) if k == "concat" else v)
          for k, v in c.items()}
    return x, sigma, jc, tc


def test_unet_encoder_cache_contract_and_matches_jax(models):  # noqa: F811
    """A forward that returns its cache, against JAX's cached denoiser; a
    decoder-only forward from that cache equals the full forward; the
    decoder leaves the returned cache whole."""
    jm, tm = models
    x, sigma, jc, tc = _cond(1)
    jdfn = jm.make_denoiser_fn_cached(T)
    ref, jcache = jax.jit(lambda p, xx, s, c: jdfn((p, jnp.zeros((1, T))), xx, s, c, None))(
        jm.params, jnp.asarray(x), jnp.asarray(sigma), jc)
    dfn = tm.make_denoiser_fn(T, torch.zeros((1, T)), cached=True)
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    with torch.no_grad():
        out, cache = dfn(xt, torch.from_numpy(sigma), tc, None)
        skips = [s.clone() for s in cache[0]]
        again, same = dfn(xt, torch.from_numpy(sigma), tc, cache)
        plain = tm.make_denoiser_fn(T, torch.zeros((1, T)))(xt, torch.from_numpy(sigma), tc)
    assert same is cache and len(cache[0]) == len(tm.model.diffusion_model.input_blocks)
    for a, b in zip(cache[0], skips):
        assert torch.equal(a, b)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    torch.testing.assert_close(plain, out, rtol=0, atol=0)
    scale = np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=0, atol=UNET_RTOL * scale)
    jskips, jh = jcache
    assert len(jskips) == len(cache[0])
    for got, want in list(zip(cache[0], jskips)) + [(cache[1], jh)]:
        want = np.asarray(want)
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=UNET_RTOL * np.abs(want).max())


def _orbit_inputs(seed):
    rnd = np.random.RandomState(seed)
    frames = rnd.rand(T, RES, RES, 3).astype(np.float32) * 2.0 - 1.0
    noise = rnd.randn(T, RES // 8, RES // 8, 4).astype(np.float32)
    cond_frames = (frames[:1] + 0.02 * rnd.randn(1, RES, RES, 3)).astype(np.float32)
    aug = np.array([0.02], np.float32)
    jkw = dict(rng=jax.random.PRNGKey(0), randn=jnp.asarray(noise),
               batch_overrides={"cond_frames": jnp.asarray(cond_frames),
                                "cond_aug": jnp.asarray(aug)})
    tkw = dict(randn=noise,
               batch_overrides={"cond_frames": torch.from_numpy(cond_frames).permute(0, 3, 1, 2),
                                "cond_aug": torch.from_numpy(aug)})
    return frames, jkw, tkw


def _narrow_interval(model):
    """An interval around the first σ only: CFG on step 0, single passes after."""
    sig = model.sampler.schedule()
    return float(sig[0]) * 0.99, float(sig[0]) * 1.01


@pytest.mark.parametrize("mode", [{"encoder_reuse": 1}, {"encoder_reuse": 2}, "narrow"])
def test_generate_orbit_turbo_matches_jax(models, mode):  # noqa: F811
    from hi3d_tpu.pipelines.i2v import generate_orbit as jax_generate_orbit
    from hi3d_tpu_torch.pipelines.i2v import generate_orbit

    jm, tm = models
    if mode == "narrow":
        mode = {"cfg_interval": _narrow_interval(tm)}
    frames, jkw, tkw = _orbit_inputs(3)
    ref = jax_generate_orbit(jm, frames, elevation=10.0, **jkw, **mode)
    out = generate_orbit(tm, frames, elevation=10.0, **tkw, **mode)
    exact = generate_orbit(tm, frames, elevation=10.0, **tkw)
    assert out.shape == ref.shape == (T, RES, RES, 3) and np.all(np.isfinite(out))
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    if mode.get("encoder_reuse") == 1:
        np.testing.assert_array_equal(out, exact)  # k = 1: the exact path's math
    else:
        assert np.abs(out - exact).max() > 1e-3  # an approximation, not the exact path


def test_cfg_interval_full_cover_is_the_exact_path(models):  # noqa: F811
    from hi3d_tpu_torch.pipelines.i2v import generate_orbit

    _, tm = models
    frames, _, tkw = _orbit_inputs(4)
    exact = generate_orbit(tm, frames, **tkw)
    covered = generate_orbit(tm, frames, cfg_interval=(0.0, 1e9), **tkw)
    np.testing.assert_array_equal(covered, exact)


def test_engine_sample_rejects_modes_by_signature(models):  # noqa: F811
    """As the JAX engine: both modes together raise, and a sampler whose
    `__call__` lacks a mode raises for it."""
    from hi3d_tpu_torch.config import instantiate_from_config

    _, tm = models
    kw = dict(cond={}, shape=(T, 2, 2, 4))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tm.sample(encoder_reuse=2, cfg_interval=(0.1, 1.0), **kw)
    old = tm.sampler
    cfg = tiny_config("x")["params"]["sampler_config"]
    cfg["target"] = "sgm.modules.diffusionmodules.sampling.DPMPP2MSampler"
    tm.sampler = instantiate_from_config(cfg)
    try:
        for mode in ({"encoder_reuse": 2}, {"cfg_interval": (0.1, 1.0)}):
            with pytest.raises(ValueError, match="DPMPP2MSampler does not support"):
                tm.sample(**mode, **kw)
    finally:
        tm.sampler = old


@pytest.mark.parametrize("mode", [{"encoder_reuse": 2}, "narrow"])
def test_orbit_server_turbo_matches_jax_per_asset(models, mode):  # noqa: F811
    from hi3d_tpu.pipelines.i2v import generate_orbit as jax_generate_orbit
    from hi3d_tpu_torch.pipelines.serve import OrbitServer

    jm, tm = models
    if mode == "narrow":
        mode = {"cfg_interval": _narrow_interval(tm)}
    n, res = 2, RES  # the shapes of the test above: JAX reuses its compiled programs
    rnd = np.random.RandomState(9)
    images = rnd.rand(n, res, res, 3).astype(np.float32) * 2.0 - 1.0
    noise = rnd.randn(n * T, res // 8, res // 8, 4).astype(np.float32)
    cond_frames = (images + 0.02 * rnd.randn(n, res, res, 3)).astype(np.float32)
    aug = np.full((n,), 0.02, np.float32)
    elevations = [5.0, -10.0]
    out = OrbitServer(tm).generate(
        images, elevations=elevations, randn=noise,
        batch_overrides={"cond_frames": torch.from_numpy(cond_frames).permute(0, 3, 1, 2),
                         "cond_aug": torch.from_numpy(aug)}, **mode)
    ref = np.stack([jax_generate_orbit(
        jm, np.repeat(images[a:a + 1], T, axis=0), elevation=elevations[a],
        rng=jax.random.PRNGKey(a), randn=jnp.asarray(noise[a * T:(a + 1) * T]),
        batch_overrides={"cond_frames": jnp.asarray(cond_frames[a:a + 1]),
                         "cond_aug": jnp.asarray(aug[a:a + 1])}, **mode) for a in range(n)])
    assert out.shape == ref.shape == (n, T, res, res, 3)
    assert np.abs(ref[1] - ref[0]).max() > 0.05  # the two assets differ
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


# -- the four CLIs take both flags, and reject them together --

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    from test_torch_stage2 import tiny_stage2_config

    from hi3d_tpu_torch.utils.png import write_png

    root = tmp_path_factory.mktemp("turbo_cli")
    s1, s2 = root / "stage1.yaml", root / "stage2.yaml"
    s1.write_text(yaml.safe_dump({"model": tiny_config(
        "test_torch_slice.TinyImageEmbedderTorch", num_steps=2)}))
    s2.write_text(yaml.safe_dump({"model": tiny_stage2_config(
        "test_torch_slice.TinyImageEmbedderTorch", num_steps=2)}))
    images = root / "images"
    images.mkdir()
    rnd = np.random.RandomState(2)
    for i in range(2):
        write_png(str(images / f"a{i}.png"), rnd.randint(0, 255, (40, 40, 3)).astype(np.uint8))
    frames = root / "first_step" / "frames"
    frames.mkdir(parents=True)
    for i in range(T):
        write_png(str(frames / f"{i:03d}.png"), rnd.randint(0, 255, (32, 32, 3)).astype(np.uint8))
    return root, str(s1), str(s2)


def _cli(name, root, s1, s2, out):
    """(main, argv) of CLI `name` on the tiny configs, CPU, 32² / 64²."""
    from hi3d_tpu_torch.pipelines import full, i2v, serve, v2v

    image = str(root / "images" / "a0.png")
    return {
        "i2v": (i2v.main, ["--denoise_config", s1, "--image_path", image, "--output_dir", out,
                           "--skip_rembg", "--resolution", "32", "32", "--clip_size", str(T)]),
        "v2v": (v2v.main, ["--denoise_config", s2, "--image_path", image,
                           "--video_path", str(root / "first_step" / "frames"),
                           "--output_dir", out, "--resolution", "64", "64",
                           "--clip_size", str(T)]),
        "serve": (serve.main, ["--image_dir", str(root / "images"), "--output_dir", out,
                               "--mode", "two_stage", "--stage1_config", s1,
                               "--stage2_config", s2, "--clip_size", str(T),
                               "--resolution", "32", "32", "--stage2_resolution", "64", "64"]),
        "full": (full.main, ["--image_path", image, "--output_dir", out, "--stage1_config", s1,
                             "--stage2_config", s2, "--stage1_resolution", "32", "32",
                             "--stage2_resolution", "64", "64", "--clip_size", str(T),
                             "--skip_rembg", "--no_metrics"]),
    }[name]


@pytest.mark.parametrize("name", ["i2v", "v2v", "serve", "full"])
def test_cli_rejects_both_turbo_flags(cli_inputs, tmp_path, name):
    main, argv = _cli(name, *cli_inputs, str(tmp_path / "out"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        main(argv + ["--device", "cpu", "--encoder_reuse", "2", "--cfg_interval", "0.3", "6"])


@pytest.mark.parametrize("name,flags", [
    ("i2v", ["--cfg_interval", "0.3", "6"]), ("v2v", ["--encoder_reuse", "2"]),
    ("serve", ["--encoder_reuse", "2"]), ("full", ["--cfg_interval", "0.3", "6"])])
def test_cli_runs_with_one_turbo_flag(cli_inputs, tmp_path, name, flags, monkeypatch):
    """Each CLI runs to its end with one flag, and the flag reaches every
    stage's sampler or blend loop."""
    from hi3d_tpu_torch.diffusion.samplers import EDMSampler

    seen = []
    call, step_call = EDMSampler.__call__, EDMSampler.step_call

    def spy_call(self, *a, **kw):
        seen.append(("call", kw.get("encoder_reuse", 0), kw.get("cfg_interval")))
        return call(self, *a, **kw)

    def spy_step(self, denoiser, x, i, *a, **kw):
        seen.append(("step", i, kw.get("use_cfg", True)))
        return step_call(self, denoiser, x, i, *a, **kw)

    monkeypatch.setattr(EDMSampler, "__call__", spy_call)
    monkeypatch.setattr(EDMSampler, "step_call", spy_step)
    main, argv = _cli(name, *cli_inputs, str(tmp_path / "out"))
    main(argv + ["--device", "cpu"] + flags)
    calls = [s for s in seen if s[0] == "call"]
    steps = [s for s in seen if s[0] == "step"]
    if flags[0] == "--cfg_interval":
        assert all(c[2] == (0.3, 6.0) for c in calls)
        # σ_max = 700 over 2 steps: no σ_i in [0.3, 6], so every step is single-pass
        assert all(not s[2] for s in steps)
    else:
        assert all(c[1] == 2 for c in calls)
    assert len(calls) == {"i2v": 1, "v2v": 0, "serve": 1, "full": 1}[name]
    assert len(steps) == {"i2v": 0, "v2v": 2, "serve": 2, "full": 2}[name]
