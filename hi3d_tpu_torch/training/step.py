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

Not ported: JAX's `param_sharding="fsdp"` (parameters and EMA sharded too),
which only `make_train_step` reaches.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..parallel.dist import mean_over_ranks
from ..parallel.zero import ZeroAdamW
from .ema import ema_update


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
    parallel over the process group's ranks."""

    def __init__(self, loss_fn: Callable, params: List[torch.nn.Parameter],
                 optimizer: torch.optim.Optimizer,
                 lr_scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                 accum_steps: int = 1, grad_clip: Optional[float] = None,
                 ema_decay: Optional[float] = None):
        self.loss_fn = loss_fn
        self.params = list(params)
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.accum_steps = int(accum_steps)
        self.grad_clip = grad_clip
        self.ema_decay = ema_decay
        self.ema_params = ([p.detach().clone() for p in self.params]
                           if ema_decay is not None else None)
        self.step = 0

    def __call__(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict:
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
        if self.ema_params is not None:
            ema_update(self.ema_params, self.params, self.step, self.ema_decay)
        return {"loss": loss, "grad_norm": grad_norm}
