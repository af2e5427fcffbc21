"""Multi-GPU training on the CPU: a 2-rank gloo group against JAX's sharded
step and the port's one-process step.

One spawn per module (`dist_run`): two processes run every scenario of
tests/torch_dist_scenarios.py (which imports no JAX) and save their results;
the tests here compare them. Every collective has a 60 s timeout and the
spawn is joined within SPAWN_LIMIT_S, so a deadlock fails the tests instead
of hanging the suite.

What is compared, and within what (fp32 throughout):
- the toy MLP of tests/test_training.py: the 2-rank ZeRO step against JAX's
  `make_train_step` on a 2-device mesh, with JAX's own tolerances (loss 1e-5
  relative; parameters and EMA rtol 2e-5, atol 1e-6);
- the tiny stage-1 engine of tests/test_torch_training.py, each rank on its
  video of the global batch with its slice of the pinned σ, ε and ucg masks.
  A step is a gradient and an update: the averaged 2-rank gradient against
  JAX's on the global batch within test_loss_gradients_match_jax's bound (and
  the loss within 1e-5); the ZeRO AdamW against optax, both fed one seeded
  gradient, within test_adamw_and_schedule_match_optax's bounds. Against
  the port's one-process step: the loss within 1e-6 relative and each
  gradient within 1e-5 of its tensor's largest entry plus 1e-7 of the
  network's (the two half-batch gradients are summed in another order than
  the one batch's);
  the ZeRO update from the 2-rank gradient within 1e-7 of torch AdamW's
  per-parameter update from the same gradient (AdamW is elementwise; on the
  CPU its vectorised loop splits a flat slice where it splits each
  parameter differently);
- resumed runs (ucg, σ, ε and the conditioning pinned, only the UNet's `out`
  trained, with EMA): the step after a resume at the other world size
  against the uninterrupted run, parameters and EMA within rtol 1e-5,
  atol 1e-7.
"""

import contextlib
import copy
import multiprocessing
import os
import socket
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import yaml

import torch_dist_scenarios as scen
from test_torch_training import (
    B, RES, T, _engines, _jax_loss_and_grads, _jax_ucg_masks, _pinned_inputs, _torch_batch,
    _write_renders, train_config,
)

WORLD = 2
SPAWN_LIMIT_S = 240
SCHED = dict(warm_up_steps=[10], f_min=[0.1], f_max=[1.0], f_start=[0.5], cycle_lengths=[100])


def _free_ports(n: int):
    """`n` distinct ports that were free (all bound at once, then let go)."""
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def _pinned(inp, masks, lo, hi):
    """The pinned batch and draws of videos [lo, hi) of the global batch."""
    batch = {k: v[lo:hi] if isinstance(v, torch.Tensor) else v
             for k, v in _torch_batch(inp).items()}
    noise = torch.from_numpy(inp["noise"]).permute(0, 3, 1, 2)[lo * T:hi * T]
    keep = [None if m is None else torch.from_numpy(m[lo:hi] if len(m) == B else m[lo * T:hi * T])
            for m in masks]
    return {"batch": batch, "sigmas": torch.from_numpy(inp["sigmas"][lo:hi]), "noise": noise,
            "masks": keep}


def _optax_steps(jm, grads):
    """Two steps of JAX's AdamW with SCHED (lr 1e-3) from the engine's
    parameters on `grads`: the parameters and Adam's moments by torch
    name."""
    import optax

    from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch
    from hi3d_tpu.training.schedules import LambdaLinearScheduler as JaxLinear
    from hi3d_tpu.training.state import build_optimizer as jax_build

    tx = jax_build(1e-3, jm.params, trained_param_keys=("all",), scheduler=JaxLinear(**SCHED))
    state = tx.init(jm.params)
    new = jm.params
    for _ in range(2):
        updates, state = tx.update(grads, state, new)
        new = optax.apply_updates(new, updates)
    return {k: _export_tree(jax.device_get(v), unet_path_to_torch, "")
            for k, v in (("params", new), ("mu", state[0].mu), ("nu", state[0].nu))}


def _random_grads(jm):
    """A seeded gradient for every UNet parameter, as JAX's tree and by
    torch name (the exported layout)."""
    from hi3d_tpu.convert.jax_to_torch import _export_tree, unet_path_to_torch

    leaves, tree = jax.tree_util.tree_flatten(jm.params)
    rnd = np.random.RandomState(7)
    grads = jax.tree_util.tree_unflatten(
        tree, [rnd.standard_normal(np.shape(x)).astype(np.float32) for x in leaves])
    return grads, {n: np.asarray(v) for n, v in
                   _export_tree(grads, unet_path_to_torch, "").items()}


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dist"))
    jm, tm = _engines(T)
    inp = _pinned_inputs()
    rng = jax.random.PRNGKey(3)
    masks = _jax_ucg_masks(jm, rng)
    # the same engine, its embedder stand-in in a module without JAX
    cfg = train_config("torch_dist_scenarios.TinyImageEmbedder")
    state = os.path.join(work, "engine.pt")
    torch.save(tm.state_dict(), state)
    pinned = _pinned(inp, masks, 0, B)

    # data: renders, tar shards of them, the CLI's config
    renders = _write_renders(Path(work) / "renders", 4, RES, seed=4)
    from hi3d_tpu_torch.data.video_dataset import pack_folder_to_shards

    pack_folder_to_shards(renders, os.path.join(work, "shards"), objects_per_shard=1)
    cli_model = copy.deepcopy(cfg)
    cli_model["params"]["ckpt_path"] = os.path.join(work, "missing.safetensors")
    cli_config = os.path.join(work, "cli.yaml")
    with open(cli_config, "w") as f:
        yaml.safe_dump({"model": cli_model, "lightning": {"logger": "jsonl"},
                        "data": {"target": "sgm.data.video_dataset.VideoDataset",
                                 "params": {"base_folder": renders, "width": RES, "height": RES,
                                            "sample_frames": T, "batch_size": 1,
                                            "num_workers": 1}}}, f)

    rnd = jax.random.PRNGKey(0)
    mlp = {"w1": np.asarray(jax.random.normal(rnd, (16, 32)) * 0.1),
           "w2": np.asarray(jax.random.normal(jax.random.fold_in(rnd, 1), (32, 8)) * 0.1),
           "x": np.asarray(jax.random.normal(jax.random.fold_in(rnd, 2), (16, 16))),
           "y": np.asarray(jax.random.normal(jax.random.fold_in(rnd, 3), (16, 8)))}
    given_tree, given = _random_grads(jm)
    inputs = {"mlp": mlp, "cfg": cfg, "state": state,
              "pinned": [_pinned(inp, masks, r, r + 1) for r in range(WORLD)],
              "pinned_global": pinned,
              "given_grads": given, "sched": SCHED,
              "renders": renders,
              "shards": os.path.join(work, "shards", "*.tar"), "res": RES, "frames": T,
              "cli_config": cli_config, "cli_logdir": os.path.join(work, "cli_logs")}

    t0 = time.perf_counter()
    ports = _free_ports(3)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=scen.run, args=(r, WORLD, ports, work, inputs))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # meanwhile: JAX's loss and gradient on the global batch, optax on
        # the seeded gradient
        tj = time.perf_counter()
        jloss, jg, _ = _jax_loss_and_grads(jm, inp, rng)
        optax_run = _optax_steps(jm, given_tree)
        tj = time.perf_counter() - tj
    finally:
        deadline = time.monotonic() + SPAWN_LIMIT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung or any(p.exitcode for p in procs):
        pytest.fail(f"ranks exited {[p.exitcode for p in procs]} "
                    f"({len(hung)} killed after {SPAWN_LIMIT_S} s)")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    for r in range(WORLD):
        ranks[r]["failure"] = torch.load(os.path.join(work, f"failure{r}.pt"))
    print(f"[dist] {WORLD} ranks ran every scenario in {time.perf_counter() - t0:.1f} s "
          f"(JAX meanwhile {tj:.1f} s)")
    return {"ranks": ranks, "work": work, "cfg": cfg, "state": state, "pinned": pinned,
            "jloss": jloss, "jg": jg, "optax": optax_run, "plain": ranks[0]["plain"],
            "inputs": inputs}


def test_zero_step_matches_jax_sharded_step(dist_run):
    """The toy MLP of test_sharded_train_step_matches_single_device: the
    port's 2-rank ZeRO step (AdamW 1e-2, EMA 0.9999) against JAX's
    `make_train_step` on a 2-device mesh, on the same global batch."""
    from hi3d_tpu.parallel.mesh import make_mesh
    from hi3d_tpu.training.state import TrainState, build_optimizer
    from hi3d_tpu.training.step import make_train_step, place_state

    m = dist_run["inputs"]["mlp"]

    def loss_fn(params, batch, rng):
        pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return jnp.mean((pred - batch["y"]) ** 2)

    params = {"w1": jnp.asarray(m["w1"]), "w2": jnp.asarray(m["w2"])}
    batch = {"x": jnp.asarray(m["x"]), "y": jnp.asarray(m["y"])}
    tx = build_optimizer(1e-2, params)
    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    st = place_state(TrainState.create(params, tx, use_ema=True), mesh)
    step = make_train_step(loss_fn, tx, mesh=mesh, ema_decay=0.9999, donate=False)(st, batch)
    st2, metrics = step(st, batch, jax.random.PRNGKey(7))
    for r in dist_run["ranks"]:
        got = r["mlp"]
        assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
        for name, p, e in zip(("w1", "w2"), got["params"], got["ema"]):
            np.testing.assert_allclose(p.numpy(), np.asarray(st2.params[name]), rtol=2e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(e.numpy(), np.asarray(st2.ema_params[name]), rtol=2e-5,
                                       atol=1e-6)


def test_zero_step_clips_and_accumulates_as_one_process(dist_run):
    """The toy MLP with 2 micro-batches a rank and clipping at a global norm
    of 0.05 (below the gradient's): the 2-rank ZeRO step against the port's
    1-process step on the global batch (4 micro-batches of the same rows)."""
    from hi3d_tpu_torch.training.state import build_optimizer
    from hi3d_tpu_torch.training.step import TrainStep

    m = dist_run["inputs"]["mlp"]
    w1 = torch.nn.Parameter(torch.from_numpy(m["w1"]))
    w2 = torch.nn.Parameter(torch.from_numpy(m["w2"]))
    step = TrainStep(lambda b, g: ((torch.tanh(b["x"] @ w1) @ w2 - b["y"]) ** 2).mean(),
                     [w1, w2], build_optimizer([w1, w2], 1e-2), accum_steps=4, grad_clip=0.05,
                     ema_decay=0.9999)
    want = step({k: torch.from_numpy(m[k]) for k in ("x", "y")})
    assert float(want["grad_norm"]) > 0.05
    for r in dist_run["ranks"]:
        got = r["mlp_clipped"]
        assert got["loss"] == pytest.approx(float(want["loss"]), rel=1e-6)
        assert got["grad_norm"] == pytest.approx(float(want["grad_norm"]), rel=1e-6)
        for p, q in zip(got["params"], (w1, w2)):
            torch.testing.assert_close(p, q.detach(), rtol=1e-5, atol=1e-7)
        for e, q in zip(got["ema"], step.ema_params):
            torch.testing.assert_close(e, q, rtol=1e-5, atol=1e-7)


def test_zero_step_gradient_matches_jax_on_the_global_batch(dist_run):
    """The tiny engine: the 2 ranks' mean loss and their reduced, averaged
    gradient against JAX's loss and gradient on the global batch, within
    test_loss_gradients_match_jax's bounds."""
    got = dist_run["ranks"][0]["engine"]
    jloss, jg = dist_run["jloss"], dist_run["jg"]
    assert abs(got["loss"] - jloss) <= 1e-5 * abs(jloss)
    assert set(got["grads"]) == set(jg)
    gmax = max(np.abs(v).max() for v in jg.values())
    for name, g in got["grads"].items():
        scale = np.abs(jg[name]).max()
        err = np.abs(g.numpy() - jg[name]).max()
        assert err <= 1e-4 * scale + 1e-6 * gmax, f"{name}: err {err:.3e} vs max {scale:.3e}"


def test_zero_adamw_matches_optax(dist_run):
    """One seeded gradient per parameter through the ZeRO optimizer
    (reduce-scatter, AdamW on each rank's slice, all-gather, the
    LambdaLinearScheduler) and through optax, two steps: the parameters and
    the consolidated Adam moments map back by name onto optax's, within
    test_adamw_and_schedule_match_optax's bounds."""
    from hi3d_tpu_torch.training.schedules import LambdaLinearScheduler

    want, mu, nu = (dist_run["optax"][k] for k in ("params", "mu", "nu"))
    got = dist_run["ranks"][0]["zero_adamw"]
    assert set(got["params"]) == set(want)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want[n], atol=1e-6, rtol=0, err_msg=n)
        np.testing.assert_allclose(got["exp_avg"][n].numpy(), mu[n], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(got["exp_avg_sq"][n].numpy(), nu[n], rtol=1e-6, atol=1e-18)
    assert got["lr"] == pytest.approx(1e-3 * LambdaLinearScheduler(**SCHED)(2))


def test_zero_step_matches_one_process_step(dist_run):
    """The 2-rank step against the port's 1-process step on the global
    batch: loss and gradient within the fp32 reduction-order bounds of the
    module docstring; the ZeRO update against torch AdamW's per-parameter
    update from the same (2-rank) gradient."""
    from hi3d_tpu_torch.training.state import build_optimizer, freeze_frozen
    from hi3d_tpu_torch.training.step import TrainStep

    engine = scen.build_engine(dist_run["cfg"], dist_run["state"])
    scen.pin(engine, dist_run["pinned"])
    trainable = freeze_frozen(engine, ["all"])
    params = [p for _, p in trainable]
    names = [n[len("diffusion_model."):] for n, _ in trainable]
    init = [p.detach().clone() for p in params]
    step = TrainStep(lambda b, g: engine.make_loss_fn()(b, g), params,
                     build_optimizer(params, 1e-3))
    m = step(dist_run["pinned"]["batch"])
    got = dist_run["ranks"][0]["engine"]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-6)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-5)
    gmax = max(p.grad.abs().max() for p in params)
    for n, p in zip(names, params):
        err = (got["grads"][n] - p.grad).abs().max()
        assert err <= 1e-5 * p.grad.abs().max() + 1e-7 * gmax, n

    # torch AdamW, per parameter, from the 2-rank gradient
    with torch.no_grad():
        for p, p0, n in zip(params, init, names):
            p.copy_(p0)
            p.grad = got["grads"][n].clone()
    build_optimizer(params, 1e-3).step()
    for n, p in zip(names, params):
        torch.testing.assert_close(got["params"][n], p.detach(), rtol=0, atol=1e-7, msg=n)


def test_optimizer_state_is_sharded(dist_run):
    """Each rank's AdamW moments hold ⌈P/2⌉ elements, padded to the slice
    alignment, P the trainable elements; the two slices cover P."""
    for key in ("mlp", "engine"):
        sizes = [r[key] for r in dist_run["ranks"]]
        numel = sizes[0]["numel"]
        assert numel == (16 * 32 + 32 * 8 if key == "mlp" else
                         sum(v.size for v in dist_run["jg"].values()))
        for s in sizes:
            assert s["moment_numel"] == s["shard_numel"]
            assert -(-numel // WORLD) <= s["shard_numel"] < -(-numel // WORLD) + 32


def test_checkpoints_resume_across_world_sizes(dist_run, tmp_path):
    """A 2-rank checkpoint resumes in 1 process, a 1-process one on 2 ranks;
    the step after the resume equals the uninterrupted run. The 2-rank
    checkpoint has the 1-process layout: the UNet's keys and shapes, and
    AdamW's per-parameter state over every trainable parameter."""
    zero = dist_run["ranks"][0]["trainer"]
    plain = dist_run["plain"]
    work = dist_run["work"]
    for r in dist_run["ranks"]:
        assert r["trainer"]["steps"] == 2 and r["trainer"]["resumed_from"] == 1
        assert r["trainer"]["resumed_steps"] == 2

    def close(a, b):
        for n in a:
            torch.testing.assert_close(a[n], b[n], rtol=1e-5, atol=1e-7, msg=n)

    # 1 process → 2 ranks: the resumed step 2 against 1 process's step 2
    close(dist_run["ranks"][0]["trainer"]["resumed_params"], plain["params"])
    close(dict(enumerate(dist_run["ranks"][1]["trainer"]["resumed_ema"])),
          dict(enumerate(plain["ema"])))
    # 2 ranks → 1 process
    ckpt = os.path.join(work, "zero", "checkpoints", "step-00000001.pt")
    logdir = scen.seed_checkpoint(ckpt, str(tmp_path / "zero_resume"))
    engine = scen.build_engine(scen.run_config(dist_run["cfg"]), dist_run["state"])
    scen.pin(engine, dist_run["pinned"])
    trainer = scen._trainer(engine, logdir)
    assert trainer.fit(scen.host_batches(5), max_steps=2, resume=True) == 2
    close(scen.named_params(engine), zero["params"])
    close(dict(enumerate(trainer.train_step.ema_params)), dict(enumerate(zero["ema"])))

    ours = torch.load(ckpt, weights_only=True)
    ref = torch.load(os.path.join(work, "plain", "checkpoints", "step-00000001.pt"),
                     weights_only=True)
    assert set(ours) == set(ref)
    assert {k: v.shape for k, v in ours["model"].items()} == \
        {k: v.shape for k, v in ref["model"].items()}
    assert set(ours["optimizer"]["state"]) == set(ref["optimizer"]["state"]) == \
        set(range(len(trainer.param_names)))
    for i, st in ref["optimizer"]["state"].items():
        assert {k: v.shape for k, v in ours["optimizer"]["state"][i].items()} == \
            {k: v.shape for k, v in st.items()}
    assert ours["optimizer"]["param_groups"] == ref["optimizer"]["param_groups"]
    assert ours["lr_scheduler"] == ref["lr_scheduler"] and ours["step"] == ref["step"] == 1


def test_lr_line_and_step_generators(dist_run):
    """The LR line counts both ranks; the ranks' step generators differ, and
    rank 0's (like one process's) is `seed · 100003 + step`, as before."""
    from hi3d_tpu_torch.training.trainer import step_seed

    r0, r1 = (r["trainer"] for r in dist_run["ranks"])
    assert "lr = 0.001 (base 0.0005 × world 2 × accum 1 × bs 1" in r0["lr_line"]
    assert r0["seed"] == dist_run["plain"]["seed"] == 5 * 100003 + 1 == step_seed(5, 1)
    assert r1["seed"] == step_seed(5, 1, 1) != r0["seed"]


def test_interrupt_on_one_rank_stops_all(dist_run):
    """SIGUSR1 on rank 1 alone stops both ranks at the same step, and one
    checkpoint is written."""
    steps = [r["interrupt"]["steps"] for r in dist_run["ranks"]]
    assert steps == [1, 1]
    assert "SIGUSR1 on rank 1" in dist_run["ranks"][1]["interrupt"]["text"]
    ck = os.path.join(dist_run["work"], "interrupt", "checkpoints")
    assert sorted(n for n in os.listdir(ck) if n.startswith("step-")) == ["step-00000001.pt"]


def test_loaders_differ_per_rank(dist_run):
    """The folder loader is seeded `seed + rank` (rank 0's stream is one
    process's); the tar loader's ranks read disjoint shards, together all
    of them."""
    from hi3d_tpu_torch.data.video_dataset import TarShardVideoDataset, VideoDataset

    inp = dist_run["inputs"]
    (a, b) = (r["loaders"] for r in dist_run["ranks"])
    data = VideoDataset(inp["renders"], width=RES, height=RES, sample_frames=T, batch_size=2,
                        num_workers=1, seed=3).setup()
    it = data.train_dataloader()
    one = next(it)
    it.close()
    assert a["folder"]["caption"] == list(one["caption"])
    assert np.array_equal(a["folder"]["video"], one["video"])
    assert not np.array_equal(a["folder"]["video"], b["folder"]["video"])
    assert a["index"] == (0, WORLD) and b["index"] == (1, WORLD)
    assert not set(a["shards"]) & set(b["shards"])
    everything = TarShardVideoDataset(inp["shards"], width=RES, height=RES, sample_frames=T)
    assert sorted(a["shards"] + b["shards"]) == sorted(everything._host_shards(0))
    assert len(everything._host_shards(0)) == 4
    assert {c.split("_")[0] for c in a["tar"]["caption"]}.isdisjoint(
        {c.split("_")[0] for c in b["tar"]["caption"]})


def test_train_cli_under_torchrun_env(dist_run):
    """`python -m hi3d_tpu_torch.train` as torchrun starts it (the group in
    the environment, gloo on the CPU): both ranks train in one logdir, their
    weights stay equal, rank 0 writes the config snapshot and the final
    checkpoint, and the CLI leaves the group it joined."""
    (a, b) = (r["cli"] for r in dist_run["ranks"])
    assert a["logdir"] == b["logdir"] and a["step"] == b["step"] == 2
    assert a["group_left"] and b["group_left"]
    assert "× world 2 × accum 1 × bs 1" in a["text"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    assert os.listdir(dist_run["inputs"]["cli_logdir"]) == [os.path.basename(a["logdir"])]
    assert sorted(os.listdir(a["logdir"])) == ["checkpoints", "config.yaml"]
    state = torch.load(os.path.join(a["logdir"], "checkpoints", "last.pt"), weights_only=True)
    assert state["step"] == 2
    for n, p in a["params"].items():
        assert torch.equal(state["model"][n], p), n


def test_failure_on_one_rank_ends_both(dist_run):
    """A loader that raises on rank 1 alone: rank 1 re-raises its own error
    without the collective save, and rank 0, waiting in the stop-flag
    all-reduce, fails as soon as rank 1's process ends, well within the
    60 s collective timeout. Neither rank writes a checkpoint."""
    a, b = (r["failure"] for r in dist_run["ranks"])
    assert b["error"] == "bad batch 1" and b["step"] == 1
    assert "Connection closed by peer" in a["error"] and a["step"] == 1
    assert a["seconds"] < 20 and b["seconds"] < 20, (a, b)
    ck = os.path.join(dist_run["work"], "failure", "checkpoints")
    assert not os.path.isdir(ck) or not [n for n in os.listdir(ck) if n.startswith("step-")]
