"""Stage-1 training slice: hi3d_tpu_torch against hi3d_tpu on CPU, fp32.

Both packages build the tiny stage-1 engine of tests/test_torch_slice.py
with a StandardDiffusionLoss (EDMSampling, VWeighting) and ucg dropout on two
embedders, and share one set of weights (the JAX export, zero-initialised
leaves randomised). The random draws are pinned on both sides: σ and ε
through the loss's parity hooks, the ucg keep-masks by replaying the JAX
conditioner's key splits and handing the masks to the port's
`parity_ucg_keep`, cond_frames/cond_aug through the batch.

Tolerances, all fp32 with different summation orders (XLA vs ATen):
- loss value: 1e-5 relative, at 4 frames and at a 34-frame clip (the
  port's frame axis past K2's 32 frames, on #6/#7's plain versions);
- parameter gradients: max |port − jax| ≤ 1e-4 · max |jax| per tensor plus
  1e-6 · the largest gradient of the network (measured: ~3e-6 of the
  tensor's max; the second term covers tensors whose gradient is ~1e-10,
  such as conv biases followed by a GroupNorm, which are pure rounding);
- optimizer: identical gradients in, so parameters agree to 1e-6 absolute
  and the Adam moments to 1e-6 relative;
- dataset: same-size frames bit-identical; resized frames within one grey
  level (the port's float bilinear against cv2's fixed-point weights).
"""

import copy
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import yaml

from test_torch_slice import CTX, RES, T, _randomize_zeros, tiny_config

B = 2
LONG_T = 34  # a clip past K2's 32 frames: every frame-axis site on #6/#7's plain versions
UCG_EMBEDDERS = (0, 2)  # the image embedder (crossattn) and the cond-frame VAE (concat)
LOSS_CFG = {
    "target": "sgm.modules.diffusionmodules.loss.StandardDiffusionLoss",
    "params": {
        "num_frames": T,
        "batch2model_keys": ["num_video_frames", "image_only_indicator"],
        "sigma_sampler_config": {
            "target": "sgm.modules.diffusionmodules.sigma_sampling.EDMSampling",
            "params": {"p_mean": 1.0, "p_std": 1.6},
        },
        "loss_weighting_config": {
            "target": "sgm.modules.diffusionmodules.loss_weighting.VWeighting"},
    },
}
INFERENCE_KEYS = ["diffusion_model.label_emb.0.0.weight", ".emb_layers.", ".time_stack."]


def train_config(embedder_target, frames=T, **unet_params):
    """The tiny training engine on clips of `frames` frames: num_samples,
    the loss's num_frames and the frame-tied n_copies and guider follow."""
    cfg = tiny_config(embedder_target)
    p = cfg["params"]
    p["loss_fn_config"] = copy.deepcopy(LOSS_CFG)
    p["loss_fn_config"]["params"]["num_frames"] = frames
    p["num_samples"] = frames
    p["conditioner_config"]["params"]["emb_models"][2]["params"]["n_copies"] = frames
    p["sampler_config"]["params"]["guider_config"]["params"]["num_frames"] = frames
    p["network_config"]["params"].update(unet_params)
    for i in UCG_EMBEDDERS:
        p["conditioner_config"]["params"]["emb_models"][i]["ucg_rate"] = 0.5
    return cfg


def _engines(frames):
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu.convert.jax_to_torch import _export_tree, export_engine_state_dict, vae_path_to_torch
    from hi3d_tpu.convert.torch_to_jax import convert_state_dict, convert_vae_key, load_engine_params
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.convert import load_reference_state_dict

    jm = jax_instantiate(train_config("test_torch_slice.TinyImageEmbedderJax", frames))
    jm.init(latent_hw=(RES // 8, RES // 8), num_frames=2)
    sd = _randomize_zeros(export_engine_state_dict(jm), 0)
    load_engine_params(jm, sd)
    jenc = jm.conditioner.embedders[2].encoder
    enc_sd = _randomize_zeros(_export_tree(jenc.params, vae_path_to_torch, ""), 1)
    jenc.params = convert_state_dict(enc_sd, convert_vae_key)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tm = instantiate_from_config(train_config("test_torch_slice.TinyImageEmbedderTorch",
                                                  frames))
    tm.init_from_ckpt(sd)
    load_reference_state_dict(tm.conditioner.embedders[2].encoder, enc_sd)
    return jm, tm


@pytest.fixture(scope="module")
def engines():
    return _engines(T)


def _pinned_inputs(seed=0, frames=T):
    rnd = np.random.RandomState(seed)
    video = (rnd.rand(B, frames, RES, RES, 3) * 2 - 1).astype(np.float32)
    cond_frames = (video[:, 0] + 0.05 * rnd.randn(B, RES, RES, 3)).astype(np.float32)
    return {
        "video": video,
        "elevation": np.array([10.0, -10.0], np.float32),
        "cond_frames_without_noise": video[:, 0],
        "cond_frames": cond_frames,
        "cond_aug": np.array([0.05, 0.02], np.float32),
        "image_only_indicator": np.zeros((B, frames), np.float32),
        "sigmas": np.array([0.7, 3.0], np.float32),
        "noise": rnd.randn(B * frames, RES // 8, RES // 8, 4).astype(np.float32),
    }


def _jax_ucg_masks(jm, rng, frames=T):
    """Replay the JAX loss_fn's key splits (engine.make_loss_fn →
    GeneralConditioner.__call__) to get the keep masks it draws."""
    r_cond, _ = jax.random.split(rng)
    sizes = {0: B, 2: B * frames}
    masks = []
    for i, emb in enumerate(jm.conditioner.embedders):
        r_cond, _, ucg_rng = jax.random.split(r_cond, 3)
        masks.append(np.asarray(jax.random.bernoulli(ucg_rng, 1.0 - emb.ucg_rate, (sizes[i],)),
                                np.float32) if emb.ucg_rate > 0 else None)
    return masks


def _jax_loss_and_grads(jm, inp, rng):
    from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch

    jm.loss_fn.parity_sigmas = inp["sigmas"]
    jm.loss_fn.parity_noise = inp["noise"]
    batch = {k: jnp.asarray(v) for k, v in inp.items() if k not in ("sigmas", "noise")}
    loss, grads = jax.jit(jax.value_and_grad(jm.make_loss_fn()))(jm.params, batch, rng)
    grads = jax.device_get(grads)
    return float(loss), _export_tree(grads, unet_path_to_torch, ""), grads


def _torch_batch(inp):
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    return {
        "video": torch.from_numpy(inp["video"]).permute(0, 1, 4, 2, 3),
        "elevation": torch.from_numpy(inp["elevation"]),
        "cond_frames_without_noise": nchw(inp["cond_frames_without_noise"]),
        "cond_frames": nchw(inp["cond_frames"]),
        "cond_aug": torch.from_numpy(inp["cond_aug"]),
        "image_only_indicator": torch.from_numpy(inp["image_only_indicator"]),
        "num_video_frames": inp["video"].shape[1],
    }


def _torch_loss_and_grads(tm, inp, masks):
    tm.loss_fn.parity_sigmas = torch.from_numpy(inp["sigmas"])
    tm.loss_fn.parity_noise = torch.from_numpy(inp["noise"]).permute(0, 3, 1, 2)
    tm.conditioner.parity_ucg_keep = [None if m is None else torch.from_numpy(m) for m in masks]
    unet = tm.model.diffusion_model
    unet.zero_grad(set_to_none=True)
    loss = tm.make_loss_fn()(_torch_batch(inp))
    loss.backward()
    # a parameter the graph does not reach (to_q / to_k / norm2 of a
    # cross-attention over one context token: softmax over one key is 1) has
    # no .grad; its gradient is 0, as in JAX
    return loss.item(), {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                         for n, p in unet.named_parameters()}


def _grads(jm, tm, frames):
    inp = _pinned_inputs(frames=frames)
    rng = jax.random.PRNGKey(3)
    masks = _jax_ucg_masks(jm, rng, frames)
    assert all(0 < m.sum() < m.size for m in masks if m is not None), "masks exercise no dropout"
    return inp, masks, _jax_loss_and_grads(jm, inp, rng), _torch_loss_and_grads(tm, inp, masks)


@pytest.fixture(scope="module")
def grads(engines):
    return _grads(*engines, T)


@pytest.fixture(scope="module")
def long_grads():
    """`grads` on clips of LONG_T frames: the port's frame axis on #6/#7
    (their plain versions on the CPU), JAX's on its own long-clip route."""
    return _grads(*_engines(LONG_T), LONG_T)


def test_loss_matches_jax(engines, grads):
    _, tm = engines
    inp, _, (jloss, _, _), (tloss, _) = grads
    assert np.isfinite(tloss) and tloss > 0
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    # shared_step = add_custom_cond (train draws) + the same loss
    batch = {k: v for k, v in _torch_batch(inp).items() if k in ("video", "elevation")}
    loss, logs = tm.shared_step(batch, torch.Generator().manual_seed(0))
    assert loss.grad_fn is not None and torch.isfinite(loss) and logs["loss"] is loss


@pytest.mark.parametrize("frames", [T, LONG_T])
def test_loss_gradients_match_jax(request, frames):
    _, _, (jloss, jg, _), (tloss, tg) = request.getfixturevalue(
        "grads" if frames == T else "long_grads")
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(jg) == set(tg)
    unreached = 0
    gmax = max(np.abs(v).max() for v in jg.values())
    for name, g in tg.items():
        ref = jg[name]
        scale = np.abs(ref).max()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * scale + 1e-6 * gmax, f"{name}: err {err:.3e} vs max {scale:.3e}"
        if not g.any():
            assert scale == 0.0 and ("attn2.to_q" in name or "attn2.to_k" in name
                                     or "norm2" in name), name
            unreached += 1
    assert unreached < len(tg) // 4


def test_checkpointed_unet_gives_identical_gradients(engines, grads):
    """use_checkpoint recomputes blocks in the backward: bit-identical
    gradients on the CPU, and the recompute really happens (each
    checkpointed block's GroupNorms run twice)."""
    from hi3d_tpu_torch.ops import group_norm as gn

    _, tm = engines
    inp, masks, _, (tloss, tg) = grads
    unet = tm.model.diffusion_model
    calls = []
    orig = gn._forward

    def counting(*args):
        calls.append("gn")
        return orig(*args)

    gn._forward = counting
    unet.use_checkpoint = True
    try:
        loss, g2 = _torch_loss_and_grads(tm, inp, masks)
    finally:
        unet.use_checkpoint = False
        gn._forward = orig
    assert loss == tloss
    for name, g in tg.items():
        assert torch.equal(g, g2[name]), name
    n_gn = calls.count("gn")
    n_res = sum(1 for m in unet.modules() if type(m).__name__ == "VideoResBlock")
    n_attn = sum(1 for m in unet.modules() if type(m).__name__ == "SpatialVideoTransformer")
    assert n_gn == 2 * (4 * n_res + n_attn) + 1


@pytest.mark.parametrize("loss_type", ["l2", "l1"])
def test_standard_diffusion_loss_matches_jax(loss_type):
    """StandardDiffusionLoss alone, σ and ε pinned, around a small fixed
    network (the same affine map in both packages) and the real Denoiser
    with VScalingWithEDMcNoise: per-frame losses agree."""
    from hi3d_tpu.config import instantiate_from_config as jax_instantiate
    from hi3d_tpu_torch.config import instantiate_from_config

    rnd = np.random.RandomState(11)
    x = rnd.randn(B * T, 5, 6, 4).astype(np.float32)
    sig = np.array([0.3, 12.0], np.float32)
    eps = rnd.randn(*x.shape).astype(np.float32)
    mix = rnd.randn(4, 4).astype(np.float32)
    cfg = {**LOSS_CFG, "params": {**LOSS_CFG["params"], "loss_type": loss_type}}
    den = {"target": "sgm.modules.diffusionmodules.denoiser.Denoiser", "params": {
        "scaling_config": {
            "target": "sgm.modules.diffusionmodules.denoiser_scaling.VScalingWithEDMcNoise"}}}

    jl, jd = jax_instantiate(cfg), jax_instantiate(den)
    jl.parity_sigmas, jl.parity_noise = sig, eps
    jnet = lambda v, c_noise, cond, **kw: jnp.tanh(v @ mix) + c_noise[:, None, None, None]  # noqa: E731
    want = np.asarray(jl(jnet, jd, {}, jnp.asarray(x), {}, jax.random.PRNGKey(0)))

    tl, td = instantiate_from_config(cfg), instantiate_from_config(den)
    tl.parity_sigmas, tl.parity_noise = torch.from_numpy(sig), torch.from_numpy(eps).permute(0, 3, 1, 2)
    tmix = torch.from_numpy(mix)
    tnet = lambda v, c_noise, cond, **kw: (  # noqa: E731
        torch.tanh(torch.einsum("nchw,cd->ndhw", v, tmix)) + c_noise[:, None, None, None])
    got = tl(tnet, td, {}, torch.from_numpy(x).permute(0, 3, 1, 2), {}).numpy()
    assert got.shape == (B * T,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sigma_samplers_and_weightings_match_jax():
    import hi3d_tpu.diffusion.sigma_sampling as jss
    import hi3d_tpu.diffusion.weighting as jw
    import hi3d_tpu_torch.diffusion.sigma_sampling as ss
    import hi3d_tpu_torch.diffusion.weighting as w

    rand = np.random.RandomState(12).randn(6).astype(np.float32)
    np.testing.assert_allclose(
        ss.EDMSampling(1.0, 1.6)(6, rand=torch.from_numpy(rand)).numpy(),
        np.asarray(jss.EDMSampling(1.0, 1.6)(None, 6, rand=jnp.asarray(rand))), rtol=1e-6)
    disc = {"target": "sgm.modules.diffusionmodules.discretizer.EDMDiscretization",
            "params": {"sigma_max": 700.0}}
    idx = np.array([0, 3, 9, 5])
    np.testing.assert_allclose(
        ss.DiscreteSampling(disc, 10)(4, rand=torch.from_numpy(idx)).numpy(),
        np.asarray(jss.DiscreteSampling(disc, 10)(None, 4, rand=jnp.asarray(idx))), rtol=1e-6)
    sig = np.array([0.01, 0.5, 1.0, 30.0], np.float32)
    for name in ("UnitWeighting", "EDMWeighting", "VWeighting", "EpsWeighting"):
        np.testing.assert_allclose(getattr(w, name)()(torch.from_numpy(sig)).numpy(),
                                   np.asarray(getattr(jw, name)()(jnp.asarray(sig))), rtol=1e-6)
    # loss_type "lpips" builds, and refuses an output without 3 channels
    # (tests/test_torch_autoencoder.py holds its values against JAX)
    from hi3d_tpu_torch.diffusion.loss import StandardDiffusionLoss

    lp = StandardDiffusionLoss(LOSS_CFG["params"]["sigma_sampler_config"],
                               LOSS_CFG["params"]["loss_weighting_config"], loss_type="lpips")
    with pytest.raises(ValueError, match="3-channel"):
        lp.get_loss(torch.zeros(2, 4, 8, 8), torch.zeros(2, 4, 8, 8), None)


def test_trainable_params_match_jax_mask(engines):
    """inference-v01's trained_param_keys select the same parameters in both
    packages (the port's plain substring rule on reference names)."""
    from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch
    from hi3d_tpu.training.state import trainable_mask as jax_mask
    from hi3d_tpu_torch.training.state import freeze_frozen, trainable_mask

    jm, tm = engines
    jsel = {n for n, m in _export_tree(jax_mask(jm.params, INFERENCE_KEYS), unet_path_to_torch,
                                       "diffusion_model.").items() if bool(m)}
    tsel = {n for n, m in trainable_mask(tm.model, INFERENCE_KEYS).items() if m}
    assert tsel == jsel
    assert "diffusion_model.label_emb.0.0.weight" in tsel
    assert "diffusion_model.label_emb.0.0.bias" not in tsel
    assert 0 < len(tsel) < sum(1 for _ in tm.model.parameters())
    try:
        picked = freeze_frozen(tm, INFERENCE_KEYS)
        assert {n for n, _ in picked} == tsel
        assert {n for n, p in tm.model.named_parameters() if p.requires_grad} == tsel
        assert not any(p.requires_grad for p in tm.first_stage_model.parameters())
        assert not any(p.requires_grad for p in tm.conditioner.parameters())
    finally:
        tm.requires_grad_(True)


def test_adamw_and_schedule_match_optax(engines, grads):
    """Two AdamW + LambdaLinearScheduler steps from the same gradients: the
    updated parameters and the Adam moments map back by name onto optax's."""
    import optax

    from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch
    from hi3d_tpu.training.schedules import LambdaLinearScheduler as JaxLinear
    from hi3d_tpu.training.state import build_optimizer as jax_build
    from hi3d_tpu_torch.training.schedules import LambdaLinearScheduler
    from hi3d_tpu_torch.training.state import build_optimizer

    jm, tm = engines
    _, _, (_, jg, jgrads), _ = grads  # the JAX gradients, exported and as the JAX tree
    sched = dict(warm_up_steps=[10], f_min=[0.1], f_max=[1.0], f_start=[0.5], cycle_lengths=[100])
    lr = 1e-3
    tx = jax_build(lr, jm.params, trained_param_keys=("all",), scheduler=JaxLinear(**sched))
    state = tx.init(jm.params)
    new = jm.params
    for _ in range(2):
        updates, state = tx.update(jgrads, state, new)
        new = optax.apply_updates(new, updates)

    named = dict(tm.model.diffusion_model.named_parameters())
    init = {n: p.detach().clone() for n, p in named.items()}
    opt = build_optimizer(named.values(), lr)
    lrs = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=LambdaLinearScheduler(**sched))
    try:
        for _ in range(2):
            for n, p in named.items():
                p.grad = torch.from_numpy(np.array(jg[n]))
            opt.step()
            lrs.step()
        want = _export_tree(jax.device_get(new), unet_path_to_torch, "")
        adam = state[0]  # optax.adamw = chain(scale_by_adam, add_decayed_weights, lr)
        mu = _export_tree(jax.device_get(adam.mu), unet_path_to_torch, "")
        nu = _export_tree(jax.device_get(adam.nu), unet_path_to_torch, "")
        moved = 0
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-6, rtol=0, err_msg=n)
            st = opt.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(), mu[n], rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[n], rtol=1e-6, atol=1e-18)
            moved += bool((p.detach() != init[n]).any())
        assert moved == len(named)
        assert lrs.get_last_lr()[0] == pytest.approx(lr * LambdaLinearScheduler(**sched)(2))
    finally:
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(init[n])
                p.grad = None


def test_ema_update_matches_jax():
    from hi3d_tpu.training.ema import ema_update as jax_ema
    from hi3d_tpu_torch.training.ema import ema_update

    rnd = np.random.RandomState(9)
    shadow = [rnd.randn(3, 4).astype(np.float32), rnd.randn(5).astype(np.float32)]
    params = [rnd.randn(3, 4).astype(np.float32), rnd.randn(5).astype(np.float32)]
    for n in (1, 7, 10**6):
        want = jax_ema({"a": shadow[0], "b": shadow[1]}, {"a": params[0], "b": params[1]}, n,
                       decay=0.999)
        got = ema_update([torch.from_numpy(s.copy()) for s in shadow],
                         [torch.from_numpy(p) for p in params], n, decay=0.999)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want["a"]), atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want["b"]), atol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("LambdaLinearScheduler", dict(warm_up_steps=[1000], f_min=[1.0], f_max=[1.0],
                                   f_start=[1e-6], cycle_lengths=[10000000000000])),
    ("LambdaLinearScheduler", dict(warm_up_steps=[100, 50], f_min=[0.1, 0.0], f_max=[1.0, 0.5],
                                   f_start=[0.01, 0.0], cycle_lengths=[1000, 2000])),
    ("LambdaWarmUpCosineScheduler2", dict(warm_up_steps=[10, 10], f_min=[0.0, 0.0],
                                          f_max=[1.0, 0.5], f_start=[0.0, 0.0],
                                          cycle_lengths=[100, 100])),
    ("LambdaWarmUpCosineScheduler", dict(warm_up_steps=10, lr_min=0.1, lr_max=1.0,
                                         lr_start=0.0, max_decay_steps=100)),
])
def test_schedulers_match_jax(name, kwargs):
    import hi3d_tpu.training.schedules as jax_sched
    import hi3d_tpu_torch.training.schedules as sched

    ours, ref = getattr(sched, name)(**kwargs), getattr(jax_sched, name)(**kwargs)
    for n in (0, 1, 5, 9, 10, 50, 99, 100, 101, 150, 199, 500, 999, 1000, 1001, 2500, 10**5):
        assert ours(n) == pytest.approx(float(ref(n)), rel=1e-12, abs=1e-15), n
        # a plain float, so optimizer/scheduler state loads with weights_only=True on
        # torch versions that do not allow numpy scalars
        assert type(ours(n)) is float, (n, type(ours(n)))


def test_grad_accumulation_matches_full_batch():
    """accum_steps micro-batches of a batch average to the full-batch step
    (equal micro-batch sizes: the mean of means is the mean)."""
    from hi3d_tpu_torch.training.state import build_optimizer
    from hi3d_tpu_torch.training.step import TrainStep

    rnd = np.random.RandomState(10)
    batch = {"x": torch.from_numpy(rnd.randn(16, 8).astype(np.float32)),
             "y": torch.from_numpy(rnd.randn(16, 4).astype(np.float32)), "n": 3}
    w0 = torch.from_numpy(rnd.randn(8, 4).astype(np.float32) * 0.1)
    out = []
    for accum in (1, 4):
        w = torch.nn.Parameter(w0.clone())
        step = TrainStep(lambda b, g: ((b["x"] @ w - b["y"]) ** 2).mean(), [w],
                         build_optimizer([w], 1e-2), accum_steps=accum)
        out.append((step(batch), w.detach().clone()))
    (m1, w1), (m4, w4) = out
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-6)
    assert float(m1["grad_norm"]) == pytest.approx(float(m4["grad_norm"]), rel=1e-5)
    np.testing.assert_allclose(w1.numpy(), w4.numpy(), rtol=1e-5, atol=1e-7)


def test_trainer_profile_window(tmp_path, capsys):
    """profile_steps records a torch.profiler trace of the window and prints
    the op table; EMA (use_ema) follows the trained parameters."""
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.training.trainer import Trainer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        cfg = train_config("test_torch_slice.TinyImageEmbedderTorch")
        cfg["params"].update(use_ema=True, trained_param_keys=["diffusion_model.out."])
        engine = instantiate_from_config(cfg)
    inp = _pinned_inputs(1)
    batch = {k: v.numpy() if isinstance(v, torch.Tensor) else v
             for k, v in _torch_batch(inp).items() if k != "num_video_frames"}
    del batch["cond_frames"], batch["cond_frames_without_noise"], batch["cond_aug"]
    trainer = Trainer(engine, logdir=str(tmp_path / "run"), base_lr=1e-3, scale_lr=False,
                      profile_steps=(1, 2), logger_backend="jsonl")
    assert trainer.fit(iter([batch] * 3), max_steps=3, resume=False) == 3
    assert os.path.getsize(tmp_path / "run" / "profile" / "trace.json") > 0
    assert "Self CPU" in capsys.readouterr().out
    ema, params = trainer.train_step.ema_params, trainer.train_step.params
    assert len(ema) == len(params) == 4  # out.0 (GroupNorm) and out.2, weight and bias
    for e, p in zip(ema, params):
        assert not torch.equal(e, p)  # the shadow lags the parameters


def metrics_every_step(monkeypatch):
    """The train CLI logs metrics every 10th step, as JAX's does: within the
    test, its Trainer logs every step, so a short run has a row a step."""
    from hi3d_tpu_torch.training import trainer as trainer_mod

    class EveryStep(trainer_mod.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, log_every=1, **kwargs)

    monkeypatch.setattr(trainer_mod, "Trainer", EveryStep)


def _write_renders(root, n_folders, size, seed):
    from hi3d_tpu_torch.utils.png import write_png

    rnd = np.random.RandomState(seed)
    for f in range(n_folders):
        d = root / f"obj{f}"
        d.mkdir(parents=True)
        for i in range(96):
            rgba = rnd.randint(0, 256, (size, size, 4)).astype(np.uint8)
            rgba[: size // 4, :, 3] = 255  # some opaque, some translucent pixels
            write_png(str(d / f"{i:03d}.png"), rgba)
    return str(root)


@pytest.mark.parametrize("size,target", [(32, 32), (40, 32)])
def test_video_dataset_sample_matches_jax(tmp_path, monkeypatch, size, target):
    import hi3d_tpu.data.native_loader as native_loader
    from hi3d_tpu.data.video_dataset import VideoTrainDataset as JaxDataset
    from hi3d_tpu_torch.data.video_dataset import VideoTrainDataset

    monkeypatch.setattr(native_loader, "available", lambda: False)  # JAX side on cv2
    root = _write_renders(tmp_path / "renders", 2, size, seed=size)
    ours = VideoTrainDataset(root, width=target, height=target, sample_frames=16)
    ref = JaxDataset(root, width=target, height=target, sample_frames=16)
    for seed in range(3):
        got = ours.sample(np.random.RandomState(seed))
        want = ref.sample(np.random.RandomState(seed))
        assert got["video"].shape == (16, 3, target, target) and got["video"].dtype == np.float32
        assert got["caption"] == want["caption"] and got["elevation"] == want["elevation"]
        assert got["fps_id"] == 7 and got["motion_bucket_id"] == 127
        diff = np.abs(got["video"].transpose(0, 2, 3, 1) - want["video"]).max()
        assert diff <= (0.0 if size == target else 1.0 / 127.5 + 1e-6), diff


def test_train_cli_two_steps_then_resume(tmp_path, capsys, monkeypatch):
    """The port's train CLI on the CPU with a tiny config: 2 steps with
    gradient accumulation over 2 micro-batches, metrics (logged every step
    here) and checkpoints written, frozen parameters untouched; then a
    resume from `last` runs step 3 from the saved state."""
    from hi3d_tpu_torch.train import main

    metrics_every_step(monkeypatch)
    renders = _write_renders(tmp_path / "renders", 1, RES, seed=1)
    model = train_config("test_torch_slice.TinyImageEmbedderTorch")
    # out.2 is zero-initialised, so at step 1 only it has a gradient
    model["params"]["trained_param_keys"] = [".time_stack.", "label_emb", "diffusion_model.out."]
    model["params"]["ckpt_path"] = str(tmp_path / "missing.safetensors")
    model["params"]["scheduler_config"] = {
        "target": "hi3d_tpu.training.schedules.LambdaLinearScheduler",
        "params": {"warm_up_steps": [2], "f_min": [1.0], "f_max": [1.0], "f_start": [0.5],
                   "cycle_lengths": [1000]},
    }
    model["base_learning_rate"] = 1e-4
    cfg = {
        "model": model,
        "data": {"target": "sgm.data.video_dataset.VideoDataset",
                 "params": {"base_folder": renders, "width": RES, "height": RES,
                            "sample_frames": T, "batch_size": B, "num_workers": 1}},
        "lightning": {"trainer": {"accumulate_grad_batches": 2},
                      "modelcheckpoint": {"params": {"every_n_train_steps": 1, "save_top_k": 2}},
                      "logger": "jsonl"},
    }
    path = tmp_path / "tiny-train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    common = ["--base", str(path), "--no_test", "True", "--device", "cpu", "--seed", "1"]

    trainer = main([*common, "--logdir", str(tmp_path / "logs"), "--max_steps", "2"])
    out = capsys.readouterr().out
    assert "random weights (smoke mode)" in out
    assert "lr = 0.0004 (base 0.0001 × world 1 × accum 2 × bs 2" in out
    logdir = trainer.logdir
    rows = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows)
    assert rows[0]["lr"] == pytest.approx(0.0004 * 0.5)
    ckdir = os.path.join(logdir, "checkpoints")
    assert os.path.realpath(os.path.join(ckdir, "last.pt")).endswith("step-00000002.pt")
    unet = trainer.engine.model.diffusion_model
    state = torch.load(os.path.join(ckdir, "last.pt"), weights_only=True)
    assert state["step"] == 2

    def plain(node):  # only tensors and Python builtins: loadable with weights_only anywhere
        if isinstance(node, dict):
            return all(plain(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return all(plain(v) for v in node)
        return isinstance(node, (torch.Tensor, int, float, bool, str, type(None)))

    assert plain(state)
    for n, p in unet.state_dict().items():
        assert torch.equal(state["model"][n], p), n
    trained = set(trainer.param_names)
    assert trained and all(".time_stack." in n or "label_emb" in n or n.startswith(
        "diffusion_model.out.") for n in trained)

    resumed = main([*common, "--resume", logdir, "--max_steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert resumed.train_step.step == 3
    rows = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]
    kept = sorted(n for n in os.listdir(ckdir) if n.startswith("step-"))
    assert kept == ["step-00000002.pt", "step-00000003.pt"]  # save_top_k 2
    # frozen UNet parameters are the seeded initial values in every run
    first = dict(unet.named_parameters())
    for n, p in resumed.engine.model.diffusion_model.named_parameters():
        if f"diffusion_model.{n}" not in trained:
            assert torch.equal(p, first[n]), n


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    """The CLI takes every flag of JAX's with JAX's defaults (the post-train
    test pass, --outckpt and --logger are ported); what it still refuses is
    a CUDA device where there is none."""
    import train as jax_train
    from hi3d_tpu_torch.train import main, parse_args

    ours, _ = parse_args([])
    ref, _ = jax_train.parse_args([])
    assert {k: v for k, v in vars(ours).items() if k != "device"} == vars(ref)
    assert ours.no_test is False and ours.outckpt == "" and ours.logger == ""
    flags = ["--no_test", "False", "--logger", "wandb", "--outckpt", "x.safetensors"]
    assert vars(parse_args(flags)[0]) == {**vars(ours), "logger": "wandb",
                                          "outckpt": "x.safetensors"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--base", "configs/train-v01.yaml", "--device", "cuda"])


def test_trainer_is_freed_after_fit(tmp_path):
    """`fit` puts the previous SIGUSR1 handler back, so a finished trainer
    (its weights, gradients and optimizer state on the device) does not
    outlive its run: the handler's closure used to keep it alive."""
    import gc
    import signal
    import weakref

    from hi3d_tpu_torch.train import main

    renders = _write_renders(tmp_path / "renders", 1, RES, seed=2)
    model = train_config("test_torch_slice.TinyImageEmbedderTorch")
    model["params"]["ckpt_path"] = str(tmp_path / "missing.safetensors")
    cfg = {"model": model,
           "data": {"target": "sgm.data.video_dataset.VideoDataset",
                    "params": {"base_folder": renders, "width": RES, "height": RES,
                               "sample_frames": T, "batch_size": B, "num_workers": 1}},
           "lightning": {"logger": "jsonl"}}
    path = tmp_path / "tiny-train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    before = signal.getsignal(signal.SIGUSR1)
    trainer = main(["--base", str(path), "--no_test", "True", "--device", "cpu", "--seed", "1",
                    "--logdir", str(tmp_path / "logs"), "--max_steps", "1"])
    assert trainer.train_step.step == 1
    assert signal.getsignal(signal.SIGUSR1) == before
    ref = weakref.ref(trainer)
    del trainer
    gc.collect()
    assert ref() is None
