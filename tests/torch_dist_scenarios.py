"""The multi-rank side of tests/test_torch_distributed.py: what each rank of a
2-process gloo group runs. This module imports torch and hi3d_tpu_torch only,
never JAX: `run` is the entry point of the spawned processes, which write
their results with `torch.save` for the test process to compare with JAX and
with the port's own one-process runs."""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import shutil
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)  # a collective that hangs fails the test


def _embedder_base():
    from hi3d_tpu_torch.conditioners import AbstractEmbedder

    return AbstractEmbedder


class TinyImageEmbedder(_embedder_base()):
    """The crossattn stand-in of tests/test_torch_slice.py
    (`TinyImageEmbedderTorch`) without its module's JAX import: channel
    means, tiled to `ctx`."""

    def __init__(self, ctx: int = 32):
        super().__init__()
        self.ctx = int(ctx)

    def forward(self, image):
        feats = image.mean(dim=(2, 3))
        return feats.repeat(1, self.ctx // 3 + 1)[:, :self.ctx][:, None, :]


# ------------------------------------------------------------------ helpers
def build_engine(cfg: dict, state_path: str):
    """The tiny engine of `cfg` with the weights saved at `state_path`."""
    from hi3d_tpu_torch.config import instantiate_from_config

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        engine = instantiate_from_config(cfg)
    engine.load_state_dict(torch.load(state_path, weights_only=True))
    return engine


def pin(engine, pinned: dict) -> None:
    """Pin the loss's σ and ε, the ucg keep-masks and `add_custom_cond`'s
    draws (the batch comes whole from `pinned`): a step depends on the
    weights and the batch alone."""
    engine.loss_fn.parity_sigmas = pinned["sigmas"]
    engine.loss_fn.parity_noise = pinned["noise"]
    engine.conditioner.parity_ucg_keep = pinned["masks"]
    engine.add_custom_cond = lambda batch, infer=False, generator=None: dict(pinned["batch"])


def named_params(engine):
    names = dict(engine.model.diffusion_model.named_parameters())
    return {n: p.detach().clone() for n, p in names.items()}


def host_batches(n: int, stop_at=None, fail_at=None):
    """`n` placeholder loader batches (the pinned `add_custom_cond` ignores
    them); with `stop_at`, SIGUSR1 to this process as batch `stop_at` is
    handed out; with `fail_at`, the loader raises instead of handing out
    batch `fail_at`."""
    for i in range(n):
        if i == stop_at:
            os.kill(os.getpid(), signal.SIGUSR1)
        if i == fail_at:
            raise RuntimeError(f"bad batch {i}")
        yield {"video": np.zeros(1, np.float32)}


def _trainer(engine, logdir, **kwargs):
    from hi3d_tpu_torch.training.trainer import Trainer

    kw = dict(base_lr=1e-3, scale_lr=False, logger_backend="jsonl", seed=5)
    kw.update(kwargs)
    return Trainer(engine, logdir=logdir, **kw)


def seed_checkpoint(src: str, logdir: str) -> str:
    """A logdir whose `last.pt` is the checkpoint `src`."""
    ck = os.path.join(logdir, "checkpoints")
    os.makedirs(ck)
    shutil.copy(src, os.path.join(ck, os.path.basename(src)))
    os.symlink(os.path.basename(src), os.path.join(ck, "last.pt"))
    return logdir


def run_config(cfg: dict) -> dict:
    """The Trainer runs' engine: only the UNet's `out` trains, with EMA."""
    return {**cfg, "params": {**cfg["params"], "use_ema": True,
                              "trained_param_keys": ["diffusion_model.out."]}}


# ---------------------------------------------------------------- scenarios
def one_process_run(inp: dict, workdir: str) -> dict:
    """Before any group exists: the 1-process Trainer on the global batch to
    step 2, checkpointing every step; its step-1 checkpoint starts
    `<workdir>/plain_resume`, which the ranks resume."""
    engine = build_engine(run_config(inp["cfg"]), inp["state"])
    pin(engine, inp["pinned_global"])
    trainer = _trainer(engine, os.path.join(workdir, "plain"), ckpt_every_n_steps=1)
    steps = trainer.fit(host_batches(5), max_steps=2, resume=False)
    seed_checkpoint(os.path.join(workdir, "plain", "checkpoints", "step-00000001.pt"),
                    os.path.join(workdir, "plain_resume"))
    return {"steps": steps, "params": named_params(engine),
            "seed": trainer.generator.initial_seed(),
            "ema": [e.clone() for e in trainer.train_step.ema_params]}


def mlp_step(inp: dict, rank: int, world: int, grad_clip=None) -> dict:
    """The toy MLP of tests/test_training.py: one ZeRO step of this rank's
    rows of the global batch (2 micro-batches with `grad_clip`)."""
    from hi3d_tpu_torch.training.state import build_optimizer
    from hi3d_tpu_torch.training.step import TrainStep

    w1 = torch.nn.Parameter(torch.from_numpy(inp["w1"]))
    w2 = torch.nn.Parameter(torch.from_numpy(inp["w2"]))
    rows = len(inp["x"]) // world
    batch = {k: torch.from_numpy(inp[k][rank * rows:(rank + 1) * rows]) for k in ("x", "y")}

    def loss_fn(b, g):
        return ((torch.tanh(b["x"] @ w1) @ w2 - b["y"]) ** 2).mean()

    opt = build_optimizer([w1, w2], 1e-2)
    step = TrainStep(loss_fn, [w1, w2], opt, ema_decay=0.9999, grad_clip=grad_clip,
                     accum_steps=1 if grad_clip is None else 2)
    m = step(batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": [w1.detach().clone(), w2.detach().clone()],
            "ema": [e.clone() for e in step.ema_params], "shard_numel": opt.shard_numel,
            "moment_numel": opt.state[opt.shard]["exp_avg"].numel(), "numel": opt.numel}


def engine_step(inp: dict, rank: int) -> dict:
    """One ZeRO step of the tiny engine on this rank's video (σ, ε, ucg and
    cond draws pinned to its slice of the global batch's): the loss (mean
    over ranks), the reduced gradients and the updated parameters, gathered
    on rank 0; each rank's optimizer slice."""
    from hi3d_tpu_torch.training.state import build_optimizer, freeze_frozen
    from hi3d_tpu_torch.training.step import TrainStep

    engine = build_engine(inp["cfg"], inp["state"])
    pin(engine, inp["pinned"][rank])
    trainable = freeze_frozen(engine, ["all"])
    names = [n[len("diffusion_model."):] for n, _ in trainable]
    params = [p for _, p in trainable]
    opt = build_optimizer(params, 1e-3)
    step = TrainStep(lambda b, g: engine.make_loss_fn()(b, g), params, opt)
    m = step(inp["pinned"][rank]["batch"])
    grads = opt._gather(opt.shard.grad)  # the reduced, averaged gradient
    out = {"shard_numel": opt.shard_numel, "numel": opt.numel,
           "moment_numel": opt.state[opt.shard]["exp_avg"].numel()}
    if rank == 0:
        out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   grads={n: grads[o:o + p.numel()].view_as(p).clone()
                          for n, o, p in zip(names, opt.offsets, params)},
                   params={n: p.detach().clone() for n, p in zip(names, params)})
    return out


def zero_adamw_on(inp: dict, rank: int) -> dict:
    """The ZeRO optimizer fed given gradients, the same on both ranks (their
    mean is that gradient, exactly), two steps of AdamW with
    `inp["sched"]` (LambdaLinearScheduler); the parameters and the
    consolidated moments on rank 0."""
    from hi3d_tpu_torch.training.schedules import LambdaLinearScheduler
    from hi3d_tpu_torch.training.state import build_optimizer

    engine = build_engine(inp["cfg"], inp["state"])
    named = dict(engine.model.diffusion_model.named_parameters())
    opt = build_optimizer(named.values(), 1e-3)
    lrs = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=LambdaLinearScheduler(**inp["sched"]))
    for _ in range(2):
        opt.zero_grad()
        for n, p in named.items():
            p.grad.copy_(torch.from_numpy(np.array(inp["given_grads"][n])))
        opt.reduce_gradients()
        opt.step()
        lrs.step()
    sd = opt.state_dict()
    if rank:
        return {}
    return {"params": {n: p.detach().clone() for n, p in named.items()},
            "exp_avg": {n: sd["state"][i]["exp_avg"] for i, n in enumerate(named)},
            "exp_avg_sq": {n: sd["state"][i]["exp_avg_sq"] for i, n in enumerate(named)},
            "lr": lrs.get_last_lr()[0]}


def trainer_runs(inp: dict, rank: int, workdir: str) -> dict:
    """The Trainer in the group: the LR line; 2 steps checkpointed every
    step (the run the 1-process resume continues); a resume of
    `one_process_run`'s step-1 checkpoint; each rank's step generator."""
    cfg = run_config(inp["cfg"])
    out = {}
    engine = build_engine(cfg, inp["state"])
    pin(engine, inp["pinned"][rank])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        trainer = _trainer(engine, os.path.join(workdir, "zero"), ckpt_every_n_steps=1,
                           scale_lr=True, base_lr=5e-4, batch_size=1)
    out["lr_line"] = text.getvalue()
    out["steps"] = trainer.fit(host_batches(5), max_steps=2, resume=False)
    out["seed"] = trainer.generator.initial_seed()
    out["params"] = named_params(engine)
    out["ema"] = [e.clone() for e in trainer.train_step.ema_params]

    engine = build_engine(cfg, inp["state"])
    pin(engine, inp["pinned"][rank])
    resumed = _trainer(engine, os.path.join(workdir, "plain_resume"))
    out["resumed_from"] = resumed.resume_if_possible()
    out["resumed_steps"] = resumed.fit(host_batches(5), max_steps=2, resume=False)
    out["resumed_params"] = named_params(engine)
    out["resumed_ema"] = [e.clone() for e in resumed.train_step.ema_params]
    return out


def interrupt(inp: dict, rank: int, workdir: str) -> dict:
    """SIGUSR1 on rank 1 alone, as its second batch is handed out: the step
    each rank stopped at."""
    cfg = {**inp["cfg"], "params": {**inp["cfg"]["params"],
                                      "trained_param_keys": ["diffusion_model.out."]}}
    engine = build_engine(cfg, inp["state"])
    pin(engine, inp["pinned"][rank])
    trainer = _trainer(engine, os.path.join(workdir, "interrupt"), ckpt_every_n_steps=1000)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        steps = trainer.fit(host_batches(5, stop_at=1 if rank == 1 else None), max_steps=5,
                            resume=False)
    return {"steps": steps, "text": text.getvalue()}


def loaders(inp: dict, rank: int) -> dict:
    """The first batch of the folder loader (seeded `seed + rank`) and of the
    tar loader, and this rank's tar shards, with their defaults."""
    from hi3d_tpu_torch.data.video_dataset import TarShardVideoDataset, VideoDataset

    out = {}
    for kind, base in (("folder", inp["renders"]), ("tar", inp["shards"])):
        data = VideoDataset(base, width=inp["res"], height=inp["res"], sample_frames=inp["frames"],
                            batch_size=2, num_workers=1, seed=3).setup()
        it = data.train_dataloader()
        batch = next(it)
        it.close()
        out[kind] = {"caption": list(batch["caption"]), "video": batch["video"]}
    tar = TarShardVideoDataset(inp["shards"], width=inp["res"], height=inp["res"],
                               sample_frames=inp["frames"])
    out["shards"] = tar._host_shards(0)
    out["index"] = (tar.process_index, tar.process_count)
    return out


def cli(inp: dict, rank: int, port: int) -> dict:
    """`hi3d_tpu_torch.train.main` as torchrun starts it: the environment
    names the group, which the CLI joins (gloo, --device cpu) and leaves."""
    from hi3d_tpu_torch import train
    from hi3d_tpu_torch.parallel import dist as pdist

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    pdist.TIMEOUT = TIMEOUT
    with contextlib.redirect_stdout(io.StringIO()) as text:
        trainer = train.main(["--base", inp["cli_config"], "--device", "cpu", "--no_test", "True",
                              "--seed", "1", "--logdir", inp["cli_logdir"], "--max_steps", "2"])
    return {"logdir": trainer.logdir, "step": trainer.train_step.step, "text": text.getvalue(),
            "group_left": not dist.is_initialized(),
            "params": named_params(trainer.engine)}


def failure(inp: dict, rank: int, workdir: str) -> dict:
    """The loader raises on rank 1 alone as its second batch is due, while
    rank 0 waits in the step's stop-flag all-reduce: each rank's exception
    and its seconds in `fit`. Rank 1 saves nothing (the save is a
    collective) and its process ends; rank 0's collective then fails."""
    cfg = {**inp["cfg"], "params": {**inp["cfg"]["params"],
                                      "trained_param_keys": ["diffusion_model.out."]}}
    engine = build_engine(cfg, inp["state"])
    pin(engine, inp["pinned"][rank])
    trainer = _trainer(engine, os.path.join(workdir, "failure"), ckpt_every_n_steps=1000)
    t0 = time.monotonic()
    error = None
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.fit(host_batches(5, fail_at=1 if rank == 1 else None), max_steps=5,
                        resume=False)
    except RuntimeError as e:
        error = str(e)
    return {"error": error, "seconds": time.monotonic() - t0, "step": trainer.train_step.step}


def run(rank: int, world: int, ports, workdir: str, inp: dict) -> None:
    """A spawned rank: (rank 0) the 1-process run, then join the gloo group
    on `ports[0]`, run every scenario (the CLI's group on `ports[1]`), save
    the results to `<workdir>/rank<rank>.pt`; last, in a group on
    `ports[2]`, the failure on one rank, saved to
    `<workdir>/failure<rank>.pt`, after which rank 1's process ends with
    that group still open."""
    torch.set_num_threads(2)
    out = {"plain": one_process_run(inp, workdir)} if rank == 0 else {}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]))
    dist.init_process_group("gloo", rank=rank, world_size=world, timeout=TIMEOUT)
    out.update({"mlp": mlp_step(inp["mlp"], rank, world),
                "mlp_clipped": mlp_step(inp["mlp"], rank, world, grad_clip=0.05),
           "engine": engine_step(inp, rank),
           "zero_adamw": zero_adamw_on(inp, rank),
           "trainer": trainer_runs(inp, rank, workdir),
           "interrupt": interrupt(inp, rank, workdir),
           "loaders": loaders(inp, rank)})
    dist.destroy_process_group()
    out["cli"] = cli(inp, rank, ports[1])
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))

    os.environ.update(MASTER_PORT=str(ports[2]))
    dist.init_process_group("gloo", rank=rank, world_size=world, timeout=TIMEOUT)
    torch.save(failure(inp, rank, workdir), os.path.join(workdir, f"failure{rank}.pt"))


# ------------------------------------------------------------------- FSDP
def _resident(step) -> dict:
    """What a rank holds of the trained state between steps, in elements."""
    opt = step.optimizer
    return {"flat_param_bytes": opt.flat_param.untyped_storage().nbytes(),
            "flat_grad_bytes": opt.flat_grad.untyped_storage().nbytes(),
            "shard": opt.shard.numel(), "shard_grad": opt.shard.grad is not None,
            "ema": None if step.ema_shard is None else step.ema_shard.numel(),
            "moments": opt.state[opt.shard]["exp_avg"].numel(),
            "resident_bytes": step.resident_bytes()}


def fsdp_mlp(inp: dict, rank: int, world: int, sharding: str, steps: int) -> dict:
    """The toy MLP of tests/test_training.py: `steps` steps of this rank's
    rows of the global batch (AdamW 1e-2, EMA 0.9999) with the parameters
    sharded as `sharding` says: the loss of each step, what the rank holds
    between steps, and the full parameters and EMA after each step."""
    from hi3d_tpu_torch.training.state import build_optimizer
    from hi3d_tpu_torch.training.step import TrainStep

    w1 = torch.nn.Parameter(torch.from_numpy(inp["w1"]))
    w2 = torch.nn.Parameter(torch.from_numpy(inp["w2"]))
    rows = len(inp["x"]) // world
    batch = {k: torch.from_numpy(inp[k][rank * rows:(rank + 1) * rows]) for k in ("x", "y")}

    def loss_fn(b, g):
        return ((torch.tanh(b["x"] @ w1) @ w2 - b["y"]) ** 2).mean()

    step = TrainStep(loss_fn, [w1, w2], build_optimizer([w1, w2], 1e-2), ema_decay=0.9999,
                     param_sharding=sharding)
    out = {"loss": [], "resident": [], "params": [], "ema": [], "numel": step.optimizer.numel,
           "shard_numel": step.optimizer.shard_numel}
    for _ in range(steps):
        out["loss"].append(float(step(batch)["loss"]))
        if sharding == "fsdp":
            out["resident"].append(_resident(step))
        else:
            out["resident"].append({"resident_bytes": step.resident_bytes()})
        with step.gathered():
            out["params"].append([w1.detach().clone(), w2.detach().clone()])
            out["ema"].append([e.clone() for e in step.ema_params])
    return out


def fsdp_trainer(inp: dict, rank: int, workdir: str, sharding: str) -> dict:
    """The tiny engine's Trainer, 2 steps on this rank's pinned video, its
    TrainStep built with `sharding` before the first step: the rank-0
    checkpoint (a consolidated one under either sharding) and the trained
    parameters gathered."""
    from hi3d_tpu_torch.training.step import TrainStep

    engine = build_engine(run_config(inp["cfg"]), inp["state"])
    pin(engine, inp["pinned"][rank])
    trainer = _trainer(engine, os.path.join(workdir, f"trainer_{sharding}"), seed=5)
    old = trainer.train_step
    trainer.train_step = TrainStep(old.loss_fn, old.params, trainer.optimizer,
                                   trainer.lr_scheduler, accum_steps=old.accum_steps,
                                   ema_decay=old.ema_decay, param_sharding=sharding)
    del old
    steps = trainer.fit(host_batches(5), max_steps=2, resume=False)
    state = trainer.state_dict()
    with trainer.train_step.gathered():
        params = named_params(engine)
    return {"steps": steps, "state": state, "params": params}


def fsdp_run(rank: int, world: int, port: int, workdir: str, inp: dict) -> None:
    """A spawned rank of tests/test_torch_fsdp.py: join a gloo group on
    `port`, run the FSDP scenarios and their replicated counterparts, save
    the results to `<workdir>/fsdp<rank>.pt`."""
    torch.set_num_threads(2)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world, timeout=TIMEOUT)
    out = {f"mlp_{s}": fsdp_mlp(inp["mlp"], rank, world, s, steps=2)
           for s in ("fsdp", "replicated")}
    out.update({f"trainer_{s}": fsdp_trainer(inp, rank, workdir, s)
                for s in ("fsdp", "replicated")})
    dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"fsdp{rank}.pt"))
