"""One optimizer step (counterpart of hi3d_tpu/training/step.py).

Loss and backward over `accum_steps` micro-batches — the batch's leading
axis cut into equal parts, the losses and gradients averaged, as the JAX step
does — then optional clipping by global norm, the AdamW update, the LR
schedule, and EMA. Metrics: `loss` (mean over micro-batches) and `grad_norm`
(global L2 norm of the averaged gradients, before clipping).

Data parallelism (the JAX step's "data" mesh axis): with a
`parallel.zero.ZeroAdamW` as the optimizer, each rank steps on its own part
of the global batch, accumulates its micro-batches locally, and reduces once
after the last (as JAX reduces once after its `lax.scan`): the gradients are
reduce-scattered and averaged into the rank's optimizer slice, the norm is
global, the update is all-gathered; `loss` is the mean over the ranks. EMA
stays replicated on every rank, as in JAX's replicated mode.

`param_sharding="fsdp"` (JAX's `make_train_step(param_sharding="fsdp")`,
hi3d_tpu/training/step.py:37-58,110-160) shards the parameters and the EMA
over the ranks as well (`ZeroAdamW.shard_parameters`): between steps a rank
keeps its slice of the flat parameters, of the EMA and of the moments; the
full parameters are all-gathered before the first micro-batch and freed,
with the full gradient, after the update, and EMA is updated on the slice.
`gathered()` brings the full parameters and EMA back for inspection and
for `Trainer.state_dict`. As in JAX, the Trainer and the CLI reach only
"replicated" (hi3d_tpu/training/trainer.py:322,389).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..parallel.dist import mean_over_ranks
from ..parallel.zero import ZeroAdamW
from .ema import ema_update

PARAM_SHARDINGS = ("replicated", "fsdp")


def split_batch(batch: Dict, parts: int) -> List[Dict]:
    """Cut every tensor with a leading batch axis into `parts` equal
    micro-batches; other values (ints) are shared."""
    if parts == 1:
        return [batch]
    out: List[Dict] = [{} for _ in range(parts)]
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.ndim:
            if len(v) % parts:
                raise ValueError(f"batch key {k!r} of length {len(v)} does not split into {parts}")
            m = len(v) // parts
            for i in range(parts):
                out[i][k] = v[i * m:(i + 1) * m]
        else:
            for micro in out:
                micro[k] = v
    return out


class TrainStep:
    """step(batch, generator) → metrics; the optimizer, schedule and EMA
    state live on the object. A `ZeroAdamW` optimizer makes the step data
    parallel over the process group's ranks; `param_sharding="fsdp"` (a
    `ZeroAdamW` only) shards the parameters and EMA too. Under "fsdp"
    `ema_params` is None outside `gathered()` and the slice is `ema_shard`."""

    def __init__(self, loss_fn: Callable, params: List[torch.nn.Parameter],
                 optimizer: torch.optim.Optimizer,
                 lr_scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                 accum_steps: int = 1, grad_clip: Optional[float] = None,
                 ema_decay: Optional[float] = None, param_sharding: str = "replicated"):
        if param_sharding not in PARAM_SHARDINGS:
            raise ValueError(f"param_sharding {param_sharding!r} not in {PARAM_SHARDINGS}")
        if param_sharding == "fsdp":
            if not isinstance(optimizer, ZeroAdamW):
                raise ValueError("param_sharding='fsdp' needs the ZeroAdamW of a process group")
            optimizer.shard_parameters()
        self.loss_fn = loss_fn
        self.params = list(params)
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.accum_steps = int(accum_steps)
        self.grad_clip = grad_clip
        self.ema_decay = ema_decay
        self.ema_params = ([p.detach().clone() for p in self.params]
                           if ema_decay is not None and not self.fsdp else None)
        self.ema_shard = (optimizer.shard.detach().clone()
                          if ema_decay is not None and self.fsdp else None)
        self.step = 0

    @property
    def fsdp(self) -> bool:
        """The parameters are sharded ("fsdp"); the optimizer holds the mode."""
        return getattr(self.optimizer, "fsdp", False)

    @contextlib.contextmanager
    def gathered(self):
        """Within: under "fsdp", every trained parameter holds its full value
        and `ema_params` the full EMA (views of all-gathered flat buffers; a
        collective on entry). What is written to them inside is kept: on
        exit each rank copies its slice back, then the full buffers are
        freed. Under "replicated" nothing changes."""
        if not self.fsdp:
            yield
            return
        opt = self.optimizer
        opt.gather_parameters()
        flat_ema = None
        if self.ema_shard is not None:
            flat_ema = torch.empty_like(opt.flat_param)
            dist.all_gather_into_tensor(flat_ema, self.ema_shard)
            self.ema_params = [flat_ema[off:off + n].view_as(p)
                               for p, off, n in zip(self.params, opt.offsets, opt.numels)]
        try:
            yield
        finally:
            with torch.no_grad():
                opt.shard.copy_(opt.flat_param[opt.lo:opt.hi])
                if flat_ema is not None:
                    self.ema_shard.copy_(flat_ema[opt.lo:opt.hi])
            self.ema_params = None
            opt.release()

    def resident_bytes(self) -> int:
        """Bytes of the trained state this process holds: the parameters
        (or their slice), gradients, EMA and AdamW's moments, each storage
        counted once. Read between steps, it is what the sharding keeps."""
        tensors = list(self.params) + [p.grad for p in self.params if p.grad is not None]
        tensors += [t for st in self.optimizer.state.values() for t in st.values()
                    if isinstance(t, torch.Tensor)]
        if isinstance(self.optimizer, ZeroAdamW):
            tensors += [self.optimizer.shard, self.optimizer.flat_grad]
            if self.optimizer.shard.grad is not None:
                tensors.append(self.optimizer.shard.grad)
        tensors += list(self.ema_params or []) + [t for t in (self.ema_shard,) if t is not None]
        storages = {}
        for t in tensors:
            st = t.untyped_storage()
            storages[(st.device, st.data_ptr())] = st.nbytes()
        return sum(storages.values())

    def __call__(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict:
        if self.fsdp:
            self.optimizer.gather_parameters()
        self.optimizer.zero_grad(set_to_none=True)
        total = 0.0
        for micro in split_batch(batch, self.accum_steps):
            loss = self.loss_fn(micro, generator)
            (loss / self.accum_steps).backward()
            total = total + loss.detach()
        loss = total / self.accum_steps
        if isinstance(self.optimizer, ZeroAdamW):
            # a parameter the graph does not reach keeps its zeroed view of
            # the flat gradient, so every rank reduces the same buffer
            grad_norm = self.optimizer.reduce_gradients()
            if self.grad_clip is not None:
                self.optimizer.clip_grads_with_norm_(self.grad_clip, grad_norm)
            loss = mean_over_ranks(loss)
        else:
            for p in self.params:
                if p.grad is None:  # not reached by the graph: its gradient is 0, and AdamW
                    p.grad = torch.zeros_like(p)  # still applies weight decay, as optax does
            grad_norm = torch.nn.utils.get_total_norm([p.grad for p in self.params])
            if self.grad_clip is not None:
                torch.nn.utils.clip_grads_with_norm_(self.params, self.grad_clip, grad_norm)
        self.optimizer.step()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self.step += 1
        if self.ema_shard is not None:
            ema_update([self.ema_shard], [self.optimizer.shard], self.step, self.ema_decay)
        elif self.ema_params is not None:
            ema_update(self.ema_params, self.params, self.step, self.ema_decay)
        return {"loss": loss, "grad_norm": grad_norm}
