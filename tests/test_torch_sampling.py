"""The port's sampling surface against hi3d_tpu on CPU, in fp32: the six
samplers (with churn), the guiders, discretizations, scalings and
DiscreteDenoiser, the LMS coefficients, the step-flag helpers, the
guidance interval on a toy denoiser, and the registry.

Toy denoiser: D(x, σ, c) = x·(1 + 0.1·mean(c_vector)) / (1 + σ), with
LinearPredictionGuider CFG over 4 frames. Stochastic samplers (churn,
ancestral) draw through `_noise` in the port; the tests replace it with
the JAX package's own draws (`jax.random.normal(split(rng, n)[i], ...)`)
for the steps that draw, so both sides add the same noise.

Tolerance: both sides are fp32 and differ in the order of a few float32
operations per step (host numpy against XLA for the σ coefficients). x
starts at σ₀ = 700 scale, so rounding there leaves ~1e-5 of |x|; samplers
are held to 2e-4 absolute at outputs of O(10) (the deterministic and the
pinned stochastic alike), coefficient math to 1e-6 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import hi3d_tpu.diffusion.samplers as jsamplers
import hi3d_tpu_torch.diffusion.samplers as tsamplers

T = 4
STEPS = 6
DISC = {"target": "sgm.modules.diffusionmodules.discretizer.EDMDiscretization",
        "params": {"sigma_max": 700.0}}
GUIDE = {"target": "sgm.modules.diffusionmodules.guiders.LinearPredictionGuider",
         "params": {"num_frames": T, "max_scale": 2.5}}
VCFG = {"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG", "params": {"scale": 2.0}}
ATOL = 2e-4


def jden(x, sigma, c):
    gain = 1.0 + 0.1 * jnp.mean(c["vector"], axis=1)
    gain = jnp.repeat(gain, x.shape[0] // gain.shape[0], 0)
    return x * gain[:, None, None, None] / (1.0 + sigma[:, None, None, None])


def tden(x, sigma, c):
    gain = 1.0 + 0.1 * c["vector"].mean(dim=1)
    gain = gain.repeat_interleave(x.shape[0] // gain.shape[0], 0)
    return x * gain[:, None, None, None] / (1.0 + sigma[:, None, None, None])


def _inputs(seed, b=1):
    rnd = np.random.RandomState(seed)
    x = rnd.randn(b * T, 3, 4, 4).astype(np.float32)
    vec = rnd.randn(b, 8).astype(np.float32)
    return x, vec


def _run_both(name, kw, seed=0, steps=STEPS, guider=GUIDE, call_kw=None):
    """(port, JAX) outputs of sampler `name`, the port's noise pinned to the
    JAX draws of the steps that draw; also returns the pinned draws left."""
    call_kw = call_kw or {}
    js = getattr(jsamplers, name)(discretization_config=DISC, guider_config=guider,
                                  num_steps=steps, **kw)
    ts = getattr(tsamplers, name)(discretization_config=DISC, guider_config=guider,
                                  num_steps=steps, **kw)
    x, vec = _inputs(seed)
    rng = jax.random.PRNGKey(seed + 1)
    draws = [np.asarray(jax.random.normal(k, x.shape, jnp.float32))
             for k in jax.random.split(rng, steps)]
    sig = ts.schedule(steps)
    if "Ancestral" in name:
        drawn = [i for i in range(steps) if sig[i + 1] > 0]
    elif kw.get("s_churn"):
        drawn = [i for i, g in enumerate(ts._gammas(sig)) if g > 0]
    else:
        drawn = []
    pinned = [torch.tensor(draws[i]) for i in drawn]
    ts._noise = lambda xx, generator: pinned.pop(0)
    ref = np.asarray(js(jden, jnp.asarray(x), {"vector": jnp.asarray(vec)},
                        uc={"vector": jnp.zeros_like(jnp.asarray(vec))}, rng=rng, **call_kw))
    out = ts(tden, torch.from_numpy(x), {"vector": torch.from_numpy(vec)},
             uc={"vector": torch.zeros(vec.shape)}, **call_kw).numpy()
    return out, ref, drawn, pinned


@pytest.mark.parametrize("name,kw", [
    ("EulerEDMSampler", {}),
    ("EulerEDMSampler", {"s_churn": 2.0, "s_tmin": 0.05, "s_tmax": 50.0}),
    ("HeunEDMSampler", {}),
    ("HeunEDMSampler", {"s_churn": 1.0, "s_noise": 1.003}),
    ("EulerAncestralSampler", {}),
    ("EulerAncestralSampler", {"eta": 0.5, "s_noise": 0.9}),
    ("DPMPP2SAncestralSampler", {}),
    ("LinearMultistepSampler", {}),
    ("LinearMultistepSampler", {"order": 2}),
    ("DPMPP2MSampler", {}),
])
def test_sampler_matches_jax(name, kw):
    out, ref, drawn, pinned = _run_both(name, kw)
    assert not pinned  # every pinned draw was taken
    if kw.get("s_churn") and "s_tmin" in kw:
        assert 0 < len(drawn) < STEPS  # churn only inside [s_tmin, s_tmax]
    assert np.all(np.isfinite(out)) and np.abs(ref).max() > 0.5
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_stochastic_samplers_draw_from_the_generator():
    """Unpinned, the port's churn and ancestral noise come from the
    generator: the same seed gives the same result, another seed another."""
    x, vec = _inputs(2)

    def run(name, kw, seed):
        s = getattr(tsamplers, name)(discretization_config=DISC, guider_config=GUIDE,
                                     num_steps=STEPS, **kw)
        g = torch.Generator().manual_seed(seed)
        return s(tden, torch.from_numpy(x), {"vector": torch.from_numpy(vec)},
                 uc={"vector": torch.zeros(vec.shape)}, generator=g).numpy()

    for name, kw in (("EulerEDMSampler", {"s_churn": 2.0}), ("EulerAncestralSampler", {})):
        a, b, c = run(name, kw, 0), run(name, kw, 0), run(name, kw, 1)
        np.testing.assert_array_equal(a, b)
        assert np.abs(a - c).max() > 1e-3


def test_churn_step_call_without_generator_raises():
    """As in JAX: churn needs a source of noise outside the full loop (the
    stage-2 blend loop passes none)."""
    s = tsamplers.EulerEDMSampler(s_churn=1.0, discretization_config=DISC, num_steps=3)
    x = torch.zeros(2, 3, 4, 4)
    with pytest.raises(ValueError, match="requires a generator"):
        s.step_call(tden, x, 0, s.schedule(), {"vector": torch.zeros(1, 8)},
                    {"vector": torch.zeros(1, 8)})


def test_step_call_matches_jax_step_call():
    """One externally driven step (the blend loop's) with churn γ and Heun's
    correction: the port's `step_call` against JAX's at every step index,
    the churn noise pinned to JAX's draw of the step."""
    x, vec = _inputs(4)
    jc, tc = {"vector": jnp.asarray(vec)}, {"vector": torch.from_numpy(vec)}
    juc, tuc = {"vector": jnp.zeros((1, 8))}, {"vector": torch.zeros(1, 8)}
    kw = dict(s_churn=1.0, discretization_config=DISC, guider_config=GUIDE, num_steps=STEPS)
    js, ts = jsamplers.HeunEDMSampler(**kw), tsamplers.HeunEDMSampler(**kw)
    sig_j = js.discretization(STEPS)
    sig_t = ts.schedule(STEPS)
    np.testing.assert_array_equal(sig_t, np.asarray(sig_j))
    s_in = jnp.ones((x.shape[0],))
    for i in range(STEPS):
        rng = jax.random.PRNGKey(i)
        ts._noise = lambda xx, g, rng=rng: torch.tensor(np.asarray(
            jax.random.normal(rng, x.shape, jnp.float32)))
        ref = np.asarray(js.step_call(jden, jnp.asarray(x), i, s_in, sig_j, STEPS + 1, jc, juc,
                                      rng=rng))
        out = ts.step_call(tden, torch.from_numpy(x), i, sig_t, tc, tuc,
                           generator=torch.Generator()).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL * max(1.0, np.abs(ref).max()))


def test_lms_coefficients_match_jax():
    disc = {"target": DISC["target"], "params": {"sigma_max": 700.0}}
    js = jsamplers.LinearMultistepSampler(order=4, discretization_config=disc, num_steps=25)
    ts = tsamplers.LinearMultistepSampler(order=4, discretization_config=disc, num_steps=25)
    sig = ts.schedule()
    got = ts._coeff_matrix(sig)
    assert got.shape == (25, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, js._coeff_matrix(sig))
    # the first rows use fewer past derivatives; row i's weights sum to Δσ_i
    assert not got[0, 1:].any() and not got[2, 3:].any()
    np.testing.assert_allclose(got.sum(axis=1), np.diff(sig), rtol=1e-3)


@pytest.mark.parametrize("flags", [
    [False, False, True, True, True, False], [True] * 4, [False], [True, False] * 3,
    np.array([True, True, False])])
def test_flag_segments_match_jax(flags):
    assert tsamplers._flag_segments(flags) == jsamplers._flag_segments(flags)


@pytest.mark.parametrize("n,k", [(25, 3), (25, 1), (4, 2), (7, 5), (1, 2)])
def test_reuse_flags_match_jax(n, k):
    from hi3d_tpu.diffusion.encoder_reuse import reuse_flags as jax_reuse_flags
    from hi3d_tpu_torch.diffusion.encoder_reuse import reuse_flags

    got = reuse_flags(n, k)
    assert got == [bool(v) for v in np.asarray(jax_reuse_flags(n, k))]
    assert not got[0] and not got[-1]
    if (n, k) == (25, 3):
        assert got.count(False) == 9  # 9 full steps, 16 decoder-only


def test_ancestral_step_matches_jax():
    sf = np.array([700.0, 10.0, 0.5, 0.01], np.float32)
    st = np.array([300.0, 2.0, 0.0, 0.002], np.float32)
    for eta in (1.0, 0.5, 0.0):
        got = tsamplers.get_ancestral_step(sf, st, eta)
        want = jsamplers.get_ancestral_step(jnp.asarray(sf), jnp.asarray(st), eta)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0)


# -- guidance interval on a toy denoiser (JAX tests/test_samplers.py:334-425) --

def _cfg_run(sampler, x, **kw):
    vec = torch.full((2, 8), 0.1)
    return sampler(tden, torch.from_numpy(x), {"vector": vec},
                   uc={"vector": torch.zeros(2, 8)}, **kw).numpy()


def python_euler_cfg_interval(x0, sigmas, scale, flags, g_c, g_uc):
    """Euler-EDM with CFG applied only on flagged steps (fp64 host loop)."""
    x = x0 * np.sqrt(1 + sigmas[0] ** 2)
    for i in range(len(sigmas) - 1):
        s = sigmas[i]
        d_c = g_c * x / (1 + s)
        if flags[i]:
            d_uc = g_uc * x / (1 + s)
            denoised = d_uc + scale * (d_c - d_uc)
        else:
            denoised = d_c
        x = x + (sigmas[i + 1] - s) * (x - denoised) / s
    return x


def test_cfg_interval_matches_python_reference_and_jax():
    s = tsamplers.EulerEDMSampler(num_steps=8, discretization_config=DISC, guider_config=VCFG)
    x0 = np.random.RandomState(3).randn(2, 4, 8, 8).astype(np.float32)
    lo, hi = 0.5, 30.0
    out = _cfg_run(s, x0, cfg_interval=(lo, hi))
    sig = s.schedule().astype(np.float64)
    flags = (sig[:-1] >= lo) & (sig[:-1] <= hi)
    assert flags.any() and not flags.all()
    ref = python_euler_cfg_interval(x0.astype(np.float64), sig, 2.0, flags, g_c=1.01, g_uc=1.0)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    js = jsamplers.EulerEDMSampler(num_steps=8, discretization_config=DISC, guider_config=VCFG)
    jout = np.asarray(js(jden, jnp.asarray(x0), {"vector": jnp.full((2, 8), 0.1)},
                         uc={"vector": jnp.zeros((2, 8))}, cfg_interval=(lo, hi)))
    np.testing.assert_allclose(out, jout, rtol=0, atol=ATOL)


def test_cfg_interval_full_cover_is_the_exact_path():
    kw = dict(num_steps=6, discretization_config=DISC, guider_config=VCFG)
    x0 = np.random.RandomState(5).randn(2, 4, 8, 8).astype(np.float32)
    exact = _cfg_run(tsamplers.EulerEDMSampler(**kw), x0)
    covered = _cfg_run(tsamplers.EulerEDMSampler(**kw), x0, cfg_interval=(0.0, 1e9))
    np.testing.assert_array_equal(exact, covered)


def test_cfg_interval_flags_come_from_the_float32_schedule():
    """--cfg_interval 0.3 6 at σ_max 700 and 25 steps: CFG on steps 15–19
    exactly (a float64 recomputation of the schedule may flip a bound)."""
    s = tsamplers.EulerEDMSampler(num_steps=25, discretization_config=DISC, guider_config=VCFG)
    calls = []

    def den(x, sigma, c):
        calls.append(x.shape[0])
        return tden(x, sigma, c)

    x0 = np.zeros((2, 4, 2, 2), np.float32)
    s(den, torch.from_numpy(x0), {"vector": torch.full((2, 8), 0.1)},
      uc={"vector": torch.zeros(2, 8)}, cfg_interval=(0.3, 6.0))
    assert [i for i, b in enumerate(calls) if b == 4] == [15, 16, 17, 18, 19]
    assert calls.count(2) == 20


def test_cfg_interval_heun_matches_jax():
    """Heun's correction denoise follows the step's CFG flag."""
    out, ref, _, _ = _run_both("HeunEDMSampler", {}, seed=8, guider=VCFG,
                               call_kw={"cfg_interval": (0.5, 30.0)})
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_cfg_interval_exclusive_with_encoder_reuse():
    s = tsamplers.EulerEDMSampler(num_steps=4, discretization_config=DISC, guider_config=VCFG)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _cfg_run(s, np.zeros((2, 4, 8, 8), np.float32), cfg_interval=(0.5, 30.0),
                 encoder_reuse=2)


def test_heun_encoder_reuse_keeps_the_correction_forwards_cache():
    """Heun under encoder_reuse=2 against JAX on a toy cached denoiser whose
    output depends on its cache: a full step must keep the cache of its
    LAST forward (the correction denoise), as JAX's scan does."""

    def jdfn(extras, x, sigma, c, cache):
        fresh = cache is None
        cache = 0.5 * x if fresh else cache
        return jden(cache + 0.5 * x, sigma, c) * extras[0], cache

    def tdfn(x, sigma, c, cache=None):
        cache = 0.5 * x if cache is None else cache
        return tden(cache + 0.5 * x, sigma, c), cache

    x, vec = _inputs(6)
    kw = dict(discretization_config=DISC, guider_config=GUIDE, num_steps=STEPS)
    outs = {}
    for k in (1, 2):
        ref = np.asarray(jsamplers.HeunEDMSampler(**kw)(
            jdfn, jnp.asarray(x), {"vector": jnp.asarray(vec)},
            uc={"vector": jnp.zeros((1, 8))}, extras=(jnp.float32(1.0),), encoder_reuse=k))
        outs[k] = tsamplers.HeunEDMSampler(**kw)(
            tdfn, torch.from_numpy(x), {"vector": torch.from_numpy(vec)},
            uc={"vector": torch.zeros(1, 8)}, encoder_reuse=k).numpy()
        np.testing.assert_allclose(outs[k], ref, rtol=0, atol=ATOL * max(1, np.abs(ref).max()))
    assert np.abs(outs[2] - outs[1]).max() > 1e-2  # the reuse changed the result


# -- the other diffusion classes --

SIGMAS = np.array([0.002, 0.03, 0.7, 1.0, 14.6, 700.0], np.float32)


@pytest.mark.parametrize("name", ["EDMScaling", "EpsScaling", "VScaling", "VScalingWithEDMcNoise"])
def test_scalings_match_jax(name):
    import hi3d_tpu.diffusion.scaling as jscaling
    import hi3d_tpu_torch.diffusion.scaling as tscaling

    kw = {"sigma_data": 0.7} if name == "EDMScaling" else {}
    got = getattr(tscaling, name)(**kw)(torch.from_numpy(SIGMAS))
    want = getattr(jscaling, name)(**kw)(jnp.asarray(SIGMAS))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("params", [{}, {"linear_start": 1e-4, "linear_end": 2e-2,
                                         "num_timesteps": 500}])
def test_legacy_ddpm_discretization_matches_jax(params):
    from hi3d_tpu.diffusion import discretization as jd
    from hi3d_tpu_torch.diffusion import discretization as td

    np.testing.assert_array_equal(td.make_beta_schedule("linear", 100, 1e-4, 2e-2),
                                  jd.make_beta_schedule("linear", 100, 1e-4, 2e-2))
    np.testing.assert_array_equal(td.generate_roughly_equally_spaced_steps(25, 1000),
                                  jd.generate_roughly_equally_spaced_steps(25, 1000))
    tdisc, jdisc = td.LegacyDDPMDiscretization(**params), jd.LegacyDDPMDiscretization(**params)
    n_max = tdisc.num_timesteps
    for n in (1, 25, n_max):
        got = tdisc.get_sigmas(n)
        assert got.dtype == np.float32 and np.all(np.diff(got) < 0)  # descending
        np.testing.assert_array_equal(got, jdisc.get_sigmas(n))
    for append, flip in ((True, False), (False, True), (True, True)):
        np.testing.assert_array_equal(tdisc(10, do_append_zero=append, flip=flip).numpy(),
                                      np.asarray(jdisc(10, do_append_zero=append, flip=flip)))
    with pytest.raises(ValueError, match="exceeds"):
        tdisc.get_sigmas(n_max + 1)


@pytest.mark.parametrize("name,kw", [("IdentityGuider", {}), ("VanillaCFG", {"scale": 3.5}),
                                     ("LinearPredictionGuider",
                                      {"max_scale": 2.5, "num_frames": T,
                                       "additional_cond_keys": "extra"})])
def test_guiders_match_jax(name, kw):
    import hi3d_tpu.diffusion.guiders as jg
    import hi3d_tpu_torch.diffusion.guiders as tg

    rnd = np.random.RandomState(1)
    x = rnd.randn(T, 3, 2, 2).astype(np.float32)
    s = rnd.rand(T).astype(np.float32)
    c = {k: rnd.randn(1, 5).astype(np.float32) for k in ("vector", "crossattn", "extra")}
    c["other"] = rnd.randn(1, 2).astype(np.float32)
    uc = {k: np.zeros_like(v) for k, v in c.items()}
    jgd, tgd = getattr(jg, name)(**kw), getattr(tg, name)(**kw)
    jx, js, jc = jgd.prepare_inputs(jnp.asarray(x), jnp.asarray(s),
                                    {k: jnp.asarray(v) for k, v in c.items()},
                                    {k: jnp.asarray(v) for k, v in uc.items()})
    tx, ts, tc = tgd.prepare_inputs(torch.from_numpy(x), torch.from_numpy(s),
                                    {k: torch.from_numpy(v) for k, v in c.items()},
                                    {k: torch.from_numpy(v) for k, v in uc.items()})
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert set(tc) == set(jc)
    for k in tc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    out = rnd.randn(*tx.shape).astype(np.float32)
    np.testing.assert_allclose(tgd(torch.from_numpy(out), None).numpy(),
                               np.asarray(jgd(jnp.asarray(out), None)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("quantize_c_noise", [True, False])
def test_discrete_denoiser_matches_jax(quantize_c_noise):
    from hi3d_tpu.diffusion.denoiser import DiscreteDenoiser as JaxDiscrete
    from hi3d_tpu_torch.diffusion.denoiser import DiscreteDenoiser

    cfg = dict(
        scaling_config={"target": "sgm.modules.diffusionmodules.denoiser_scaling.EpsScaling"},
        num_idx=1000, quantize_c_noise=quantize_c_noise,
        discretization_config={
            "target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"})
    jd, td = JaxDiscrete(**cfg), DiscreteDenoiser(**cfg)
    np.testing.assert_array_equal(td.sigmas.numpy(), np.asarray(jd.sigmas))
    sigma = np.array([0.03, 1.0, 5.3, 14.6], np.float32)
    x = np.random.RandomState(2).randn(4, 3, 2, 2).astype(np.float32)
    seen = {}

    def jnet(xx, c_noise, cond):
        seen["jax"] = np.asarray(c_noise)
        return xx * 0.5 + c_noise[:, None, None, None] * 1e-3

    def tnet(xx, c_noise, cond):
        seen["port"] = c_noise.numpy()
        return xx * 0.5 + c_noise[:, None, None, None] * 1e-3

    ref = np.asarray(jd(jnet, jnp.asarray(x), jnp.asarray(sigma), {}))
    out = td(tnet, torch.from_numpy(x), torch.from_numpy(sigma), {}).numpy()
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(td.sigma_to_idx(torch.from_numpy(sigma)).numpy(),
                                  np.asarray(jd.sigma_to_idx(jnp.asarray(sigma))))


# -- the registry --

def test_every_jax_diffusion_target_resolves_in_the_port():
    from hi3d_tpu.registry import _ALIASES as JAX_ALIASES
    from hi3d_tpu_torch.config import get_obj_from_str

    mods = ("sampling", "guiders", "discretizer", "denoiser", "denoiser_scaling")
    targets = [t for t in JAX_ALIASES
               if t.rsplit(".", 1)[0] in {f"sgm.modules.diffusionmodules.{m}" for m in mods}]
    assert len(targets) == 17
    for target in targets:
        cls = get_obj_from_str(target)
        assert cls.__module__.startswith("hi3d_tpu_torch.diffusion.")
        assert cls.__name__ == target.rsplit(".", 1)[1]


def test_discrete_sampling_with_legacy_ddpm_builds_and_matches_jax():
    """A training σ sampler naming LegacyDDPMDiscretization (the reference's
    usual pairing) builds and draws the same σ levels as JAX's."""
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu_torch.config import instantiate_from_config

    cfg = {"target": "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling",
           "params": {"num_idx": 1000, "discretization_config": {
               "target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"}}}
    tsamp, jsamp = instantiate_from_config(cfg), jax_instantiate(cfg)
    np.testing.assert_array_equal(tsamp.sigmas.numpy(), np.asarray(jsamp.sigmas))
    idx = np.array([0, 1, 499, 998, 999], np.int64)
    np.testing.assert_array_equal(
        tsamp(5, rand=torch.from_numpy(idx)).numpy(),
        np.asarray(jsamp(jax.random.PRNGKey(0), 5, rand=jnp.asarray(idx))))
    drawn = tsamp(64, generator=torch.Generator().manual_seed(0)).numpy()
    assert np.isin(drawn, tsamp.sigmas.numpy()).all()
