"""The training loop (counterpart of hi3d_tpu/training/trainer.py).

LR scaling and its printed line, `fit` over a loader, a MetricsLogger that
writes metrics.jsonl and prints every `log_every`-th step (10, as the JAX
trainer) and forwards the scalars to TensorBoard or wandb when that package
imports, an ImageLogger that dumps `engine.log_images` media every
`log_images_every` steps, and a Checkpointer on `torch.save`/`torch.load`
that saves every N steps and at the end, keeps `save_top_k` files, resumes
from `checkpoints/last.pt`, and saves when the process gets SIGUSR1. Peak
device memory comes from `torch.cuda.max_memory_allocated`.

In a process group (`parallel.dist`, one process per GPU under torchrun) the
Trainer is data parallel: world = the group's size scales the LR, the
optimizer is `parallel.zero.ZeroAdamW`, each rank draws its step's noise from
its own generator, SIGUSR1 on any rank stops every rank at the same step,
and rank 0 alone writes metrics, media and checkpoints (a checkpoint is
consolidated from every rank's optimizer slice into the one-process layout,
so a run resumes at any world size).

`profile_steps=(start, stop)` records a `torch.profiler` trace of the steps
in [start, stop) to `<logdir>/profile/` and prints the kernels by device
time, as the JAX trainer's `jax.profiler` window does.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..parallel import dist as pdist
from ..parallel.zero import ZeroAdamW
from .state import build_optimizer, freeze_frozen
from .step import TrainStep


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The seed of a step's generator: `seed · 100003 + step` on rank 0 (one
    process), offset by 2⁴⁰ a rank so that no two ranks draw the same σ,
    noise or degradation."""
    return seed * 100003 + step + (rank << 40)


def device_memory_stats(device: torch.device) -> Dict[str, float]:
    """Current and peak allocated device memory in GB (CUDA only)."""
    if device.type != "cuda":
        return {}
    return {"mem_gb": round(torch.cuda.memory_allocated(device) / 2**30, 3),
            "peak_mem_gb": round(torch.cuda.max_memory_allocated(device) / 2**30, 3)}


class MetricsLogger:
    """Scalar metrics of every `log_every`-th step → `<logdir>/metrics.jsonl`,
    the console, and the backend: "tensorboard" or "testtube" write event
    files under `<logdir>/tb` (torch.utils.tensorboard), "wandb" logs to a
    wandb run; when the backend's package does not import, or for "jsonl",
    None or another name, metrics.jsonl and the console alone, as in the
    JAX trainer."""

    def __init__(self, logdir: str, device: torch.device, log_every: int = 10,
                 backend: Optional[str] = "tensorboard"):
        self.path = os.path.join(logdir, "metrics.jsonl")
        self.device = device
        self.log_every = int(log_every)
        self._t0 = time.time()
        self._tb = self._wandb = None
        if backend in ("tensorboard", "testtube"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(logdir, "tb"))
            except Exception as e:
                print(f"[trainer] tensorboard backend unavailable ({e!r}); "
                      "falling back to metrics.jsonl only")
        elif backend == "wandb":
            try:
                import wandb

                self._wandb = wandb.init(project=os.environ.get("WANDB_PROJECT", "hi3d_tpu"),
                                         dir=logdir, resume="allow")
            except Exception as e:
                print(f"[trainer] wandb backend unavailable ({e!r}); "
                      "falling back to metrics.jsonl only")

    def __call__(self, step: int, metrics: Dict) -> None:
        if step % self.log_every:
            return
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 2)}
        rec.update(device_memory_stats(self.device))
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        scalars = {k: v for k, v in rec.items() if k != "step"}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        pretty = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in rec.items() if k != "wall_s")
        print(f"[train] {pretty}", flush=True)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class ImageLogger:
    """Every `every_n_steps` steps, `engine.log_images` of the batch's first
    `max_videos` videos (noise from a generator seeded with the step) under
    `<logdir>/image_log/`: a video entry `key` of video i as PNG frames in
    `step<step:08d>_<key>_<i>/frames/` with the H.264 mp4 beside them
    (utils/video.export_to_video), an image entry as
    `step<step:08d>_<key>_<i>.png`. As in the JAX trainer, a failure is
    printed and never stops training."""

    def __init__(self, logdir: str, every_n_steps: int = 200, max_videos: int = 1, fps: int = 8):
        self.dir = os.path.join(logdir, "image_log")
        self.every = int(every_n_steps)
        self.max_videos = max_videos
        self.fps = fps

    def maybe_log(self, engine, batch: Dict, step: int) -> None:
        if step % self.every:
            return
        from ..utils.png import write_png
        from ..utils.video import export_to_video, tensor2vid

        try:
            generator = torch.Generator(device=engine.device).manual_seed(step)
            media = engine.log_images(batch, n=self.max_videos, generator=generator)
        except Exception as e:  # logging must never kill training
            print(f"[image_log] skipped at step {step}: {e}")
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            for key, vid in media.items():
                for i in range(min(len(vid), self.max_videos)):
                    name = f"step{step:08d}_{key}_{i}"
                    if np.ndim(vid[i]) == 3:  # an image entry ('conditioning')
                        img = ((np.asarray(vid[i]) + 1.0) * 127.5).clip(0, 255)
                        write_png(os.path.join(self.dir, f"{name}.png"), img.astype(np.uint8))
                        continue
                    export_to_video(tensor2vid(vid[i]), os.path.join(self.dir, name, f"{name}.mp4"),
                                    fps=self.fps)
        except Exception as e:  # logging must never kill training
            print(f"[image_log] export failed at step {step}: {e}")


class Checkpointer:
    """`<logdir>/checkpoints/step-NNNNNNNN.pt` files plus `last.pt`, a
    symlink to the newest. Keeps the newest `max_to_keep`, or with `monitor`
    the best by that metric (its values are kept in `index.json`)."""

    def __init__(self, logdir: str, every_n_steps: int = 3000, max_to_keep: int = 10,
                 monitor: Optional[str] = None, mode: str = "min"):
        self.dir = os.path.join(os.path.abspath(logdir), "checkpoints")
        if pdist.is_main():
            os.makedirs(self.dir, exist_ok=True)
        self.every = int(every_n_steps)
        self.max_to_keep = int(max_to_keep)
        self.monitor = monitor
        self.mode = mode
        self.last = os.path.join(self.dir, "last.pt")

    def save(self, step: int, state: Dict, metrics: Optional[Dict] = None) -> Optional[str]:
        """Write `state` (rank 0 only: on the other ranks it is None)."""
        if not pdist.is_main():
            return None
        name = f"step-{step:08d}.pt"
        path = os.path.join(self.dir, name)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        tmp_link = self.last + ".tmp"
        if os.path.lexists(tmp_link):
            os.remove(tmp_link)
        os.symlink(name, tmp_link)
        os.replace(tmp_link, self.last)
        self._retain(name, metrics)
        return path

    def maybe_save(self, step: int, state_fn, metrics: Optional[Dict] = None) -> None:
        """Every `every`-th step, `state_fn()` (a collective in a process
        group, so every rank calls it) saved by rank 0."""
        if step and step % self.every == 0:
            self.save(step, state_fn(), metrics)

    def _retain(self, newest: str, metrics: Optional[Dict]) -> None:
        index_path = os.path.join(self.dir, "index.json")
        index = {}
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = json.load(f)
        if self.monitor is not None:
            worst = float("inf") if self.mode == "min" else float("-inf")
            index[newest] = float((metrics or {}).get(self.monitor, worst))
        else:
            index[newest] = None
        names = sorted(n for n in index if os.path.exists(os.path.join(self.dir, n)))
        if self.monitor is not None:
            names.sort(key=lambda n: index[n], reverse=self.mode == "max")
        else:
            names.reverse()  # newest first
        for n in names[self.max_to_keep:]:
            if n != newest:
                os.remove(os.path.join(self.dir, n))
                index.pop(n)
        with open(index_path, "w") as f:
            json.dump(index, f)

    def latest(self) -> Optional[str]:
        return self.last if os.path.exists(self.last) else None

    def load(self, path: Optional[str] = None, device="cpu") -> Dict:
        return torch.load(path or self.last, map_location=device, weights_only=True)


class Trainer:
    """fit() over a loader with one TrainStep per batch, on this process's
    device: in a process group every rank runs one, on its own data."""

    def __init__(self, engine, logdir: str = "logs/run", base_lr: Optional[float] = None,
                 scale_lr: bool = True, accumulate_grad_batches: int = 1, batch_size: int = 1,
                 ckpt_every_n_steps: int = 3000, log_images_every: int = 200,
                 log_every: int = 10, max_to_keep: int = 10, monitor: Optional[str] = None,
                 monitor_mode: str = "min", seed: int = 0, grad_clip: Optional[float] = None,
                 profile_steps: Optional[Tuple[int, int]] = None,
                 logger_backend: Optional[str] = "tensorboard"):
        self.engine = engine
        self.device = engine.device
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.accum = int(accumulate_grad_batches)
        self.seed = int(seed)
        self.rank, self.main = pdist.rank(), pdist.is_main()

        base_lr = base_lr if base_lr is not None else (engine.base_learning_rate or 1e-5)
        world = pdist.world()
        self.learning_rate = base_lr * world * self.accum * batch_size if scale_lr else base_lr
        print(f"[trainer] lr = {self.learning_rate:.3g} (base {base_lr:.3g} × world {world} × "
              f"accum {self.accum} × bs {batch_size}, scale_lr={scale_lr})")

        trainable = freeze_frozen(engine, getattr(engine, "trained_param_keys", ("all",)))
        self.param_names = [n for n, _ in trainable]
        params = [p for _, p in trainable]
        self.optimizer = build_optimizer(params, self.learning_rate)
        self.lr_scheduler = None
        if engine.scheduler_config:
            from ..config import instantiate_from_config

            self.lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, lr_lambda=instantiate_from_config(engine.scheduler_config))
        self.train_step = TrainStep(
            engine.make_loss_fn(), params, self.optimizer, self.lr_scheduler,
            accum_steps=self.accum, grad_clip=grad_clip,
            ema_decay=engine.ema_decay_rate if engine.use_ema else None)
        self.metrics = (MetricsLogger(logdir, self.device, log_every=log_every,
                                      backend=logger_backend) if self.main else None)
        self.image_logger = ImageLogger(logdir, every_n_steps=log_images_every)
        self.checkpointer = Checkpointer(logdir, every_n_steps=ckpt_every_n_steps,
                                         max_to_keep=max_to_keep, monitor=monitor,
                                         mode=monitor_mode)
        self.generator = torch.Generator(device=self.device)
        self.profile_steps = profile_steps
        self.last_metrics: Dict = {}
        self._interrupted = False

    # --------------------------------------------------------------- state
    def state_dict(self) -> Optional[Dict]:
        """The checkpoint: step, the UNet, the optimizer (one process's
        per-parameter AdamW layout), the LR schedule, EMA. In a process
        group a collective, and None on ranks other than 0. A step whose
        parameters are sharded ("fsdp") is gathered for it, and rank 0
        keeps copies on the CPU, so the checkpoint is the plain one."""
        optimizer = self.optimizer.state_dict()
        with self.train_step.gathered():
            if not self.main:
                return None
            sched = self.lr_scheduler.state_dict() if self.lr_scheduler is not None else None
            if sched is not None:
                sched = {k: v for k, v in sched.items() if k != "lr_lambdas"}  # a config object
            model = self.engine.model.diffusion_model.state_dict()
            ema = self.train_step.ema_params
            if self.train_step.fsdp:  # the gathered buffers are freed on exit
                model = {k: v.to("cpu", copy=True) for k, v in model.items()}
                ema = None if ema is None else [e.to("cpu", copy=True) for e in ema]
            return {
                "step": self.train_step.step,
                "model": model,
                "optimizer": optimizer,
                "lr_scheduler": sched,
                "ema": ema,
            }

    def load_state_dict(self, state: Dict) -> None:
        with self.train_step.gathered():
            self.engine.model.diffusion_model.load_state_dict(state["model"], strict=True)
            if state["ema"] is not None and self.train_step.ema_params is not None:
                for s, v in zip(self.train_step.ema_params, state["ema"]):
                    s.copy_(v)
        self.optimizer.load_state_dict(state["optimizer"])
        if self.lr_scheduler is not None:
            self.lr_scheduler.load_state_dict({**state["lr_scheduler"], "lr_lambdas": [None]})
        self.train_step.step = int(state["step"])

    def resume_if_possible(self) -> int:
        """Load `checkpoints/last.pt` when it exists (every rank reads it;
        in a process group through the CPU, each rank keeping its slice)."""
        path = self.checkpointer.latest()
        if path is None:
            return 0
        where = "cpu" if isinstance(self.optimizer, ZeroAdamW) else self.device
        self.load_state_dict(self.checkpointer.load(path, where))
        print(f"[trainer] resumed from step {self.train_step.step} ({os.path.realpath(path)})")
        return self.train_step.step

    @contextlib.contextmanager
    def _ema_weights(self):
        """Within: the trained parameters hold their EMA (when the run keeps
        one), as the JAX trainer hands `log_images` its EMA params; the
        trained values come back bit for bit after. Sharded parameters
        ("fsdp") are gathered for it."""
        with self.train_step.gathered():
            ema = self.train_step.ema_params
            if ema is None:
                yield
                return
            params = self.train_step.params
            with torch.no_grad():
                kept = [p.detach().clone() for p in params]
                torch._foreach_copy_(params, ema)
            try:
                yield
            finally:
                with torch.no_grad():
                    torch._foreach_copy_(params, kept)

    # ----------------------------------------------------------------- fit
    def _device_batch(self, batch: Dict) -> Dict:
        """numpy batch → tensors on the device (video, elevation, and at
        stage 2 masks and kernels); captions (strings) are dropped."""
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items() if not isinstance(v, (str, list))}

    def _install_signal_handler(self):
        """SIGUSR1 saves a checkpoint and stops the run. Returns the handler
        it replaced, which `fit` puts back when it ends: the handler holds the
        trainer, and with it the weights and optimizer state on the device.
        None off the main thread, where no handler can be installed."""
        def melk(*_):
            print(f"[trainer] SIGUSR1 on rank {self.rank} — saving a checkpoint and stopping")
            self._interrupted = True

        try:
            previous = signal.signal(signal.SIGUSR1, melk)
        except ValueError:
            return None
        return signal.SIG_DFL if previous is None else previous

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = os.path.join(self.logdir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        key = "cuda_time_total" if self.device.type == "cuda" else "cpu_time_total"
        print(prof.key_averages().table(sort_by=key, row_limit=40), flush=True)

    def fit(self, data: Iterable[Dict], max_steps: int, resume: bool = True) -> int:
        """Train until `max_steps` (or SIGUSR1); returns the step reached.
        The final state is saved in every case but one: in a process group,
        a rank that raises saves nothing and re-raises at once. The save is
        a collective that the other ranks, waiting in another one, would
        never join; the raising process exits and torchrun stops the rest."""
        step = self.resume_if_possible() if resume else self.train_step.step
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        prof = None
        previous_handler = self._install_signal_handler()
        ended = False
        try:
            for host_batch in data:
                # every rank stops at the same step, whichever got the signal
                if step >= max_steps or pdist.any_over_ranks(self._interrupted, self.device):
                    break
                if self.profile_steps and step == self.profile_steps[0]:
                    prof = self._start_profile()
                self.generator.manual_seed(step_seed(self.seed, step, self.rank))
                t_cond = time.perf_counter()
                batch = self.engine.add_custom_cond(self._device_batch(host_batch), infer=False,
                                                    generator=self.generator)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                lr = self.optimizer.param_groups[0]["lr"]
                metrics = self.train_step(batch, self.generator)
                metrics["lr"] = lr
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
                metrics["sec_per_step"] = time.perf_counter() - t0  # the step alone, as JAX's
                metrics["cond_s"] = t0 - t_cond  # the batch's move and add_custom_cond
                step = self.train_step.step
                self.last_metrics = metrics
                if self.metrics is not None:
                    self.metrics(step, metrics)
                if prof is not None and step == self.profile_steps[1]:
                    self._stop_profile(prof)
                    prof = None
                # sharded parameters are gathered on every rank for the dump (a collective)
                if step % self.image_logger.every == 0 and (self.main or self.train_step.fsdp):
                    with self._ema_weights():
                        if self.main:  # the captions too, which the device batch drops
                            self.image_logger.maybe_log(self.engine, {**host_batch, **batch},
                                                        step)
                self.checkpointer.maybe_save(step, self.state_dict, metrics)
            ended = True
        finally:
            if prof is not None:
                self._stop_profile(prof)
            close = getattr(data, "close", None)
            if close is not None:
                close()  # a generator loader stops its workers
            if ended or not pdist.initialized():
                self.checkpointer.save(step, self.state_dict(), self.last_metrics)
            if self.metrics is not None:
                self.metrics.close()
            if previous_handler is not None:
                signal.signal(signal.SIGUSR1, previous_handler)
        return step
