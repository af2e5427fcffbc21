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
# the serving groups' (tests/test_torch_serve_dist.py): up to 4 ranks of 9
# processes at once on a CPU that the other test workers share, so a rank's
# peers may wait on it for long; a hang still fails within the spawn's limit
SERVE_TIMEOUT = datetime.timedelta(seconds=150)


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


# ----------------------------------------------------------------- serving
def _orbit_call(server, job: dict, seed_device="cpu"):
    """OrbitServer.generate on a job of tests/test_torch_serve_dist.py: pinned
    noise and cond draws when the job carries them, else a generator seeded
    `job["seed"]` draws them."""
    kw = dict(elevations=job["elev"], encoder_reuse=job.get("encoder_reuse", 0),
              cfg_interval=job.get("cfg_interval"))
    if "noise" in job:
        kw.update(randn=job["noise"], batch_overrides={
            "cond_frames": torch.from_numpy(job["cond_frames"]).permute(0, 3, 1, 2),
            "cond_aug": torch.from_numpy(job["cond_aug"])})
    else:
        kw["generator"] = torch.Generator(device=seed_device).manual_seed(job["seed"])
    server.model.num_samples = job["t"]
    return server.generate(job["images"], **kw)


def _refine_call(server, job: dict):
    kw = dict(elevations=job["elev"], encoder_reuse=job.get("encoder_reuse", 0),
              cfg_interval=job.get("cfg_interval"))
    if "noise" in job:
        kw.update(init_noise=job["noise"], batch_overrides={
            "cond_frames": torch.from_numpy(job["cond_frames"]).permute(0, 3, 1, 2),
            "cond_aug": torch.from_numpy(job["cond_aug"])})
    else:
        kw["generator"] = torch.Generator().manual_seed(job["seed"])
    server.model.num_samples = job["videos"].shape[1]
    return server.refine(job["videos"], **kw)


def serve_engines(inp: dict, ranks=(None, None)):
    """The tiny stage-1 and stage-2 engines (each None where `ranks` names
    ranks that exclude this one), their samplers' ancestral variant kept
    aside."""
    me = dist.get_rank() if dist.is_initialized() else 0
    m1 = None if ranks[0] is not None and me not in ranks[0] else build_engine(
        inp["cfg1"], inp["state1"])
    m2 = None if ranks[1] is not None and me not in ranks[1] else build_engine(
        inp["cfg2"], inp["state2"])
    return m1, m2


@contextlib.contextmanager
def _steps(model, steps):
    """Within: the model's sampler takes `steps` steps (its own without)."""
    old = model.sampler.num_steps
    model.sampler.num_steps = steps or old
    try:
        yield
    finally:
        model.sampler.num_steps = old


def _stream_by_parts(server, job) -> list:
    """What generate_stream should give, computed by its parts: each batch's
    orbit on the stage-1 servers with the batch's generators, the videos sent
    from stage 1's first rank to every stage-2 rank, the refinement on the
    stage-2 servers; the writer's videos (None elsewhere). In one process,
    the two stages one after the other."""
    from hi3d_tpu_torch.parallel import dist as pdist

    outs = []
    for i, images in enumerate(job["batches"]):
        g1, g2 = server.stage_generators(job["seed"], i)
        elev = [job["elev"]] * len(images)
        videos = None
        if server.orbit is not None:
            videos = server.orbit.generate(images, elevations=elev, generator=g1)
        if pdist.world() > 1:
            leader = server.ranks[0][0]
            if pdist.rank() == leader:
                for dst in server.ranks[1]:
                    pdist.send_tensor(torch.from_numpy(videos), dst)
            elif server.refine is not None:
                videos = pdist.recv_tensor(leader, "cpu")
        out = None
        if server.refine is not None:
            out = server._stage2(videos, elev, g2, job["stage2_hw"], {}, "float32", None)

        outs.append(out)
    return outs


def serve_jobs(inp: dict, jobs, m1, m2, split=None) -> dict:
    """Run `jobs` ({name: job}) with the servers of this process (its group
    when one is initialised): "orbit", "orbit_ancestral" (the sampler
    swapped for EulerAncestralSampler), "refine" and "stream" (the
    TwoStageServer over 2 batches, and `<name>_parts`, the same by its
    parts); the results by name (None off the writer). `split` (world,
    rank): in one process, the rows that rank of a throughput split holds,
    as it computes them."""
    from hi3d_tpu_torch.config import instantiate_from_config
    from hi3d_tpu_torch.parallel.dist import FrameShard
    from hi3d_tpu_torch.pipelines.serve import OrbitServer, RefineServer, TwoStageServer

    def sharded(server):
        if split is not None:
            w, r = split
            server.frames = lambda b, t: FrameShard(t, b * t, r * b * t // w, b * t // w)
        return server

    out = {}
    for name, job in jobs.items():
        kind = job["kind"]
        if kind in ("orbit", "orbit_ancestral"):
            server = sharded(OrbitServer(m1, mode=job.get("mode", "auto")))
            old = m1.sampler
            if kind == "orbit_ancestral":
                m1.sampler = instantiate_from_config(inp["ancestral"])
            try:
                with _steps(m1, job.get("steps")):
                    out[name] = _orbit_call(server, job)
            finally:
                m1.sampler = old
        elif kind == "refine":
            server = sharded(RefineServer(m2, mode=job.get("mode", "auto")))
            with _steps(m2, job.get("steps")):
                out[name] = _refine_call(server, job)
        elif kind == "stream":
            for m in (m1, m2):
                if m is not None:
                    m.num_samples = job["t"]
            server = TwoStageServer(m1, m2, stage1_ranks=job.get("ranks1"),
                                    stage2_ranks=job.get("ranks2"))
            out[name] = list(server.generate_stream(
                job["batches"], elevations=job["elev"], seed=job["seed"],
                stage2_hw=job["stage2_hw"]))
            out[name + "_parts"] = _stream_by_parts(server, job)
        else:
            raise ValueError(kind)
    return out


def regroup_checks(world: int, rank: int) -> dict:
    """`FrameShard.to_locations` / `to_frames` round trips (2 copies of 2
    videos × 3 frames, 7 and 16 locations: uneven blocks at 2–4 ranks) and
    the split GroupNorm on this rank's block of the locations against the
    whole tensor's GroupNorm: the largest errors."""
    from hi3d_tpu_torch.models.layers import GroupNorm32
    from hi3d_tpu_torch.parallel.dist import FrameShard

    gen = torch.Generator().manual_seed(11)
    out = {"roundtrip": 0.0, "locations": 0.0, "group_norm": 0.0}
    for videos, frames in ((2, 3), (1, 6)):
        if (videos * frames) % world:
            continue
        shard = FrameShard.split(videos, frames, dist.group.WORLD)
        for s in (7, 16):
            full = torch.randn(2 * videos * frames, 5, s, generator=gen)
            mine = full.view(2, -1, 5, s)[:, shard.offset:shard.offset + shard.count]
            mine = mine.reshape(-1, 5, s)
            a, b = shard.location_block(s)
            loc = shard.to_locations(mine, 2)
            back = shard.to_frames(loc, 2, s)
            out["locations"] = max(out["locations"], (loc - full[:, :, a:b]).abs().max().item())
            out["roundtrip"] = max(out["roundtrip"], (back - mine).abs().max().item())
        # GroupNorm over (N, C, T, S, 1) with the locations split
        norm = GroupNorm32(8, num_groups=4, act="silu")
        with torch.no_grad():
            norm.weight.normal_(generator=gen)
            norm.bias.normal_(generator=gen)
        x = torch.randn(videos, 8, frames, 16, 1, generator=gen) * 3 + 1
        a, b = shard.location_block(16)
        with torch.no_grad():
            want = norm(x)[:, :, :, a:b]
            got = norm(x[:, :, :, a:b], shard=shard)
        out["group_norm"] = max(out["group_norm"], (got - want).abs().max().item())
    return out


def serve_cli(inp: dict, rank: int, world: int, port: int, argv) -> dict:
    """`hi3d_tpu_torch.pipelines.serve.main` as torchrun starts it (gloo,
    --device cpu): the paths this rank wrote, and whether it left the
    group."""
    from hi3d_tpu_torch.parallel import dist as pdist
    from hi3d_tpu_torch.pipelines import serve

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    pdist.TIMEOUT = SERVE_TIMEOUT
    with contextlib.redirect_stdout(io.StringIO()) as text:
        result = serve.main(list(argv) + ["--device", "cpu"])
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        os.environ.pop(k, None)
    return {"outputs": result["outputs"], "phases": result["phases"], "text": text.getvalue(),
            "group_left": not dist.is_initialized()}


def serve_run(rank: int, world: int, ports, workdir: str, inp: dict) -> None:
    """A spawned rank of tests/test_torch_serve_dist.py: join a `world`-rank
    gloo group on `ports[0]`, run this world's serving jobs and checks, then
    each CLI run of `inp["cli"][world]` in a group of its own (on
    `ports[1:]`); save the results to `<workdir>/serve<world>_<rank>.pt`."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]))
    dist.init_process_group("gloo", rank=rank, world_size=world, timeout=SERVE_TIMEOUT)
    m1, m2 = serve_engines(inp)
    out = {"jobs": serve_jobs(inp, inp["jobs"][world], m1, m2),
           "regroup": regroup_checks(world, rank)}
    dist.destroy_process_group()
    out["cli"] = {name: serve_cli(inp, rank, world, port, argv)
                  for port, (name, argv) in zip(ports[1:], inp["cli"].get(world, {}).items())}
    torch.save(out, os.path.join(workdir, f"serve{world}_{rank}.pt"))
