"""Parameter sharding ("fsdp") on the CPU: a 2-rank gloo group against JAX's
`make_train_step(param_sharding="fsdp")` on the 8-device CPU mesh, and
against the port's replicated ZeRO step.

One spawn per module (`fsdp_run`): two processes run the FSDP scenarios of
tests/torch_dist_scenarios.py (which imports no JAX) and save their results;
the tests here compare them. Every collective has a 60 s timeout and the
spawn is joined within SPAWN_LIMIT_S.

What is compared, and within what (fp32 throughout):
- the toy MLP of tests/test_training.py::
  test_fsdp_param_sharding_matches_replicated, two steps: the loss of each
  within 1e-5 relative of JAX's, the parameters and EMA after each within
  rtol 2e-5, atol 1e-6 (JAX's own tolerances);
- the same MLP under the replicated ZeRO step: loss, parameters and EMA
  bit-equal (AdamW and EMA are elementwise, so a slice computes what the
  whole computes);
- between steps each rank holds ⌈P/N⌉ parameters (rounded up to the
  32-element alignment), as many EMA and moment elements, and no full
  parameter or gradient buffer;
- the tiny engine's Trainer with its TrainStep sharded: its checkpoint (a
  collective, rank 0's) equal to the replicated run's, bit for bit, so the
  plain path loads it.
"""

import math
import multiprocessing
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
import torch_dist_scenarios as scen
from test_torch_distributed import _free_ports, _pinned
from test_torch_training import B, _pinned_inputs, train_config

WORLD = 2
SPAWN_LIMIT_S = 180


def _jax_fsdp_steps(m, steps):
    """JAX's FSDP step on the 8-device mesh, `steps` times: each step's
    loss and its (params, EMA) as numpy."""
    from hi3d_tpu.parallel.mesh import make_mesh
    from hi3d_tpu.training.state import TrainState, build_optimizer
    from hi3d_tpu.training.step import make_train_step, place_state

    def loss_fn(params, batch, rng):
        pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return jnp.mean((pred - batch["y"]) ** 2)

    params = {"w1": jnp.asarray(m["w1"]), "w2": jnp.asarray(m["w2"])}
    batch = {"x": jnp.asarray(m["x"]), "y": jnp.asarray(m["y"])}
    tx = build_optimizer(1e-2, params)
    mesh = make_mesh(data=8)
    st = place_state(TrainState.create(params, tx, use_ema=True), mesh, param_sharding="fsdp")
    step = make_train_step(loss_fn, tx, mesh=mesh, ema_decay=0.9999, donate=False,
                           param_sharding="fsdp")(st, batch)
    out = []
    for _ in range(steps):
        st, metrics = step(st, batch, jax.random.PRNGKey(7))
        for leaf in jax.tree.leaves(st.params):
            assert not leaf.sharding.is_fully_replicated
        out.append((float(metrics["loss"]),
                    {k: np.asarray(st.params[k]) for k in ("w1", "w2")},
                    {k: np.asarray(st.ema_params[k]) for k in ("w1", "w2")}))
    return out


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    from hi3d_tpu_torch.config import instantiate_from_config

    work = str(tmp_path_factory.mktemp("fsdp"))
    cfg = train_config("torch_dist_scenarios.TinyImageEmbedder")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        engine = instantiate_from_config(cfg)
    state = os.path.join(work, "engine.pt")
    torch.save(engine.state_dict(), state)
    inp = _pinned_inputs()
    rnd = np.random.RandomState(9)
    frames = inp["video"].shape[1]
    masks = [(rnd.rand(B) < 0.5).astype(np.float32), None,
             (rnd.rand(B * frames) < 0.5).astype(np.float32), None]
    rnd = jax.random.PRNGKey(0)
    mlp = {"w1": np.asarray(jax.random.normal(rnd, (16, 32)) * 0.1),
           "w2": np.asarray(jax.random.normal(jax.random.fold_in(rnd, 1), (32, 8)) * 0.1),
           "x": np.asarray(jax.random.normal(jax.random.fold_in(rnd, 2), (16, 16))),
           "y": np.asarray(jax.random.normal(jax.random.fold_in(rnd, 3), (16, 8)))}
    inputs = {"mlp": mlp, "cfg": cfg, "state": state,
              "pinned": [_pinned(inp, masks, r, r + 1) for r in range(WORLD)]}

    t0 = time.perf_counter()
    (port,) = _free_ports(1)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=scen.fsdp_run, args=(r, WORLD, port, work, inputs))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jax_steps = _jax_fsdp_steps(mlp, 2)  # meanwhile
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
    ranks = [torch.load(os.path.join(work, f"fsdp{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    print(f"[fsdp] {WORLD} ranks in {time.perf_counter() - t0:.1f} s")
    return {"ranks": ranks, "jax": jax_steps}


def test_fsdp_step_matches_jax_fsdp_step(fsdp_run):
    """Two FSDP steps of the toy MLP on 2 ranks against JAX's FSDP step on
    the 8-device mesh, JAX's tolerances."""
    for r in fsdp_run["ranks"]:
        got = r["mlp_fsdp"]
        for i, (loss, params, ema) in enumerate(fsdp_run["jax"]):
            assert got["loss"][i] == pytest.approx(loss, rel=1e-5)
            for name, p, e in zip(("w1", "w2"), got["params"][i], got["ema"][i]):
                np.testing.assert_allclose(p.numpy(), params[name], rtol=2e-5, atol=1e-6)
                np.testing.assert_allclose(e.numpy(), ema[name], rtol=2e-5, atol=1e-6)


def test_fsdp_step_is_the_replicated_zero_step(fsdp_run):
    """The same two steps with the parameters replicated: bit-equal."""
    for r in fsdp_run["ranks"]:
        a, b = r["mlp_fsdp"], r["mlp_replicated"]
        assert a["loss"] == b["loss"]
        for i in range(2):
            for x, y in zip(a["params"][i] + a["ema"][i], b["params"][i] + b["ema"][i]):
                assert torch.equal(x, y)


def test_fsdp_ranks_hold_their_slices_between_steps(fsdp_run):
    """After each step a rank holds ⌈P/N⌉ parameters, EMA and moment
    elements (up to the 32-element alignment) and no full buffer; its
    trained state is 4 fp32 slices (parameters, EMA, two moments), against
    the replicated step's full flat parameters and gradients and full EMA
    beside its moments."""
    for r in fsdp_run["ranks"]:
        got = r["mlp_fsdp"]
        p = got["numel"]
        assert p == 16 * 32 + 32 * 8
        shard = got["shard_numel"]
        assert math.ceil(p / WORLD) <= shard < math.ceil(p / WORLD) + 32 and shard % 32 == 0
        for held, plain in zip(got["resident"], r["mlp_replicated"]["resident"]):
            assert held["flat_param_bytes"] == held["flat_grad_bytes"] == 0
            assert not held["shard_grad"]
            assert held["shard"] == held["ema"] == held["moments"] == shard
            # + 4: AdamW's step count, one fp32 scalar
            assert held["resident_bytes"] == 4 * 4 * shard + 4
            assert plain["resident_bytes"] == 4 * (2 * WORLD * shard + p + 2 * shard) + 4


def test_fsdp_trainer_checkpoint_is_the_plain_one(fsdp_run):
    """The tiny engine's Trainer with its step sharded, 2 steps: the
    checkpoint rank 0 writes equals the replicated run's bit for bit (the
    UNet, EMA, AdamW's per-parameter moments, the schedule); rank 1 gets
    None; the gathered parameters equal the replicated run's."""
    r0, r1 = fsdp_run["ranks"]
    assert r1["trainer_fsdp"]["state"] is None
    a, b = r0["trainer_fsdp"], r0["trainer_replicated"]
    assert a["steps"] == b["steps"] == 2
    sa, sb = a["state"], b["state"]
    assert sa["step"] == sb["step"] and sa["lr_scheduler"] == sb["lr_scheduler"]
    assert sa["model"].keys() == sb["model"].keys()
    for k in sa["model"]:
        assert torch.equal(sa["model"][k].cpu(), sb["model"][k].cpu()), k
    for x, y in zip(sa["ema"], sb["ema"]):
        assert torch.equal(x.cpu(), y.cpu())
    assert sa["optimizer"]["param_groups"] == sb["optimizer"]["param_groups"]
    for i, st in sa["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], sb["optimizer"]["state"][i][key])
    for r in (r0, r1):
        for k, v in r["trainer_fsdp"]["params"].items():
            assert torch.equal(v, r["trainer_replicated"]["params"][k]), k


def test_fsdp_needs_the_zero_optimizer():
    """"fsdp" without a process group's ZeroAdamW, or an unknown sharding,
    raises."""
    from hi3d_tpu_torch.training.step import TrainStep

    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="ZeroAdamW"):
        TrainStep(lambda b, g: w.sum(), [w], torch.optim.AdamW([w]), param_sharding="fsdp")
    with pytest.raises(ValueError, match="param_sharding"):
        TrainStep(lambda b, g: w.sum(), [w], torch.optim.AdamW([w]), param_sharding="zero3")


def test_zero_load_state_dict_leaves_the_source_as_given():
    """ZeroAdamW copies a loaded state dict's step count: stepping after the
    load leaves the caller's dict as it was, so one dict can start two runs
    (the chip smoke's replicated and "fsdp" steps from one checkpoint)."""
    import torch.distributed as dist

    from hi3d_tpu_torch.parallel.zero import ZeroAdamW

    dist.init_process_group("gloo", rank=0, world_size=1, store=dist.HashStore())
    try:
        w = torch.nn.Parameter(torch.ones(5))
        source = {"param_groups": [{"lr": 0.1, "betas": (0.9, 0.999), "eps": 1e-8,
                                    "weight_decay": 0.0, "amsgrad": False, "maximize": False,
                                    "foreach": None, "capturable": False, "differentiable": False,
                                    "fused": None, "params": [0]}],
                  "state": {0: {"step": torch.tensor(2.0), "exp_avg": torch.full((5,), 0.1),
                                "exp_avg_sq": torch.full((5,), 0.01)}}}
        opt = ZeroAdamW([w], lr=0.1)
        opt.load_state_dict(source)
        w.grad.fill_(1.0)
        opt.reduce_gradients()
        opt.step()
        assert float(source["state"][0]["step"]) == 2.0
        assert float(opt.state[opt.shard]["step"]) == 3.0
    finally:
        dist.destroy_process_group()
