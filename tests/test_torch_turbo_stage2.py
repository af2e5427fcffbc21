"""The stage-2 blend loop's turbo modes against hi3d_tpu on CPU, in fp32:
`blend_refine_batch` with `encoder_reuse` 1 and 2 and with a narrow
`cfg_interval`, on the tiny stage-2 engines of tests/test_torch_stage2.py
(shared weights, the same frames, noise and pinned conditioning noise).
Tolerance: 2e-3 absolute on the decoded frames, the exact blend loop's
(`SLICE_ATOL`). The port's k = 1 and full-cover runs equal its exact loop
exactly: they run the same operations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import torch_threads  # noqa: F401
from test_torch_stage2 import SLICE_ATOL, _inputs, models  # noqa: F401  (module fixture)


@pytest.fixture(scope="module")
def exact(models):  # noqa: F811
    from hi3d_tpu_torch.pipelines.v2v import blend_refine_batch

    _, tm = models
    video, noise, _, tover = _inputs(6)
    return blend_refine_batch(tm, video, elevations=[10.0], init_noise=noise,
                              batch_overrides=tover)


@pytest.mark.parametrize("mode", [{"encoder_reuse": 1}, {"encoder_reuse": 2}, "narrow"])
def test_blend_refine_turbo_matches_jax(models, exact, mode, monkeypatch):  # noqa: F811
    from hi3d_tpu.pipelines.v2v import blend_refine_batch as jax_blend
    from hi3d_tpu_torch.pipelines.v2v import blend_refine_batch

    monkeypatch.setenv("HI3D_PROGRAM_CACHE", "0")
    jm, tm = models
    if mode == "narrow":  # CFG on step 0 only
        sig = tm.sampler.schedule()
        mode = {"cfg_interval": (float(sig[0]) * 0.99, float(sig[0]) * 1.01)}
    video, noise, jover, tover = _inputs(6)
    ref = jax_blend(jm, video, elevations=[10.0], rng=jax.random.PRNGKey(0),
                    init_noise=jnp.asarray(noise), batch_overrides=jover, steps_per_launch=None,
                    **mode)
    out = blend_refine_batch(tm, video, elevations=[10.0], init_noise=noise,
                             batch_overrides=tover, **mode)
    assert out.shape == ref.shape == exact.shape and np.all(np.isfinite(out))
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(out, ref, atol=SLICE_ATOL, rtol=0)
    if mode.get("encoder_reuse") == 1:
        np.testing.assert_array_equal(out, exact)
    else:
        assert np.abs(out - exact).max() > 1e-3


def test_blend_refine_full_cover_is_the_exact_loop(models, exact):  # noqa: F811
    from hi3d_tpu_torch.pipelines.v2v import blend_refine_batch

    _, tm = models
    video, noise, _, tover = _inputs(6)
    covered = blend_refine_batch(tm, video, elevations=[10.0], init_noise=noise,
                                 batch_overrides=tover, cfg_interval=(0.0, 1e9))
    np.testing.assert_array_equal(covered, exact)


def test_blend_refine_decodes_from_the_cache_on_reused_steps(models, monkeypatch):  # noqa: F811
    """encoder_reuse=2 over 3 steps: steps 0 and 2 run the whole UNet, step 1
    the output blocks alone; the two modes together raise."""
    from hi3d_tpu_torch.models.unet import VideoUNet
    from hi3d_tpu_torch.pipelines.v2v import blend_refine_batch

    _, tm = models
    calls = []
    forward = VideoUNet.forward

    def spy(self, *a, encoder_cache=None, **kw):
        calls.append(encoder_cache is not None)
        return forward(self, *a, encoder_cache=encoder_cache, **kw)

    monkeypatch.setattr(VideoUNet, "forward", spy)
    video, noise, _, tover = _inputs(7)
    blend_refine_batch(tm, video, init_noise=noise, batch_overrides=tover, encoder_reuse=2)
    assert calls == [False, True, False]
    with pytest.raises(ValueError, match="mutually exclusive"):
        blend_refine_batch(tm, video, encoder_reuse=2, cfg_interval=(0.5, 30.0))
