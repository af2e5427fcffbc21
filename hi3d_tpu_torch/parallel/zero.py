"""ZeRO-2 AdamW over the ranks of the process group (counterpart of
`zero_partition_spec`, hi3d_tpu/parallel/mesh.py:62-82, and of the dataflow
of hi3d_tpu/training/step.py:9-12: gradients reduce-scattered into their
shard owners, the parameter update all-gathered).

The trainable parameters become views of one flat fp32 buffer, and their
gradients views of another, both padded to `world × shard_numel` elements.
Rank r owns elements [r·shard_numel, (r+1)·shard_numel): AdamW's moments
exist for that slice alone, 2 × 4 B × P / world a rank. A step is

    backward (gradients accumulate in place into the flat buffer)
    reduce-scatter the flat gradient, summed, into this rank's slice; ÷ world
    global norm: all-reduce of the slices' squared norms
    torch.optim.AdamW on the slice (one flat tensor: AdamW is elementwise,
        so it computes what one AdamW over the parameter list computes)
    all-gather the updated slices into the flat parameter buffer

in place throughout (the collectives' output is the input buffer or a slice
of it), so one process holds what the plain step holds: parameters,
gradients and moments, with the moments cut by the world size. The
gradients are not partitioned in memory: every rank keeps the whole flat
gradient (P × 4 B) through the backward, so a rank holds parameters + full
gradients + EMA + moments / world. The collectives are ZeRO-2's, the memory
ZeRO-1's; DeepSpeed's stage 2 keeps only the rank's gradient partition.

`state_dict` gathers the slices to rank 0 into torch AdamW's per-parameter
layout, the one `Trainer.state_dict()` writes in one process, and
`load_state_dict` cuts that layout, from either origin, into this rank's
slice: a run resumes at another world size.

`param_sharding="fsdp"` (the JAX step's option of that name,
hi3d_tpu/training/step.py:37-58,110-160,163-194) shards the parameters too.
The rank's slice of the flat parameters lives in `shard`, storage of its
own; between steps the flat parameter and gradient buffers hold no storage
(their views, the trained parameters and their `.grad`, must not be read).
`gather_parameters` all-gathers the full flat parameters before the first
micro-batch and `zero_grad` gives the flat gradient its storage back; the
step reduce-scatters into the slice's own gradient, runs AdamW on the slice
and frees the full parameters and gradients and the slice's gradient. The
update is not all-gathered after the step: the next step's gather is the
one that brings it to every rank. A rank then keeps 1/world of the
parameters and of the moments between steps (and 1/world of the EMA, which
`training.step.TrainStep` keeps on the slice).

How the JAX package's mesh helpers (hi3d_tpu/parallel/mesh.py) map here:
- `make_mesh`/`get_mesh` (the "data" axis): the process group of
  `parallel.dist` (`init`, `rank`, `world`); the port has no tensor axis;
- `batch_sharding` (the batch over "data"): each rank loads and steps on
  its own part of the global batch (train.py, data/video_dataset.py);
- `replicated`: parameters on every rank, equal by `dist.broadcast_module`
  at start and by the all-gather of every update (`param_sharding=
  "replicated"`);
- `zero_partition_spec` + `named_shardings` (each leaf cut along a
  divisible axis): one flat, padded buffer cut into equal slices of
  `shard_numel` elements, `ALIGN`-aligned, for the moments and, under
  "fsdp", the parameters and EMA.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

ALIGN = 32  # elements: each rank's slice starts on a 128-byte boundary


def _materialize(t: torch.Tensor) -> None:
    """Give a flat buffer whose storage was freed its storage back (its
    values are undefined until written)."""
    storage = t.untyped_storage()
    need = t.numel() * t.element_size()
    if storage.nbytes() < need:
        storage.resize_(need)


def _free(t: torch.Tensor) -> None:
    """Free a flat buffer's storage; its views stay, pointing at nothing."""
    t.untyped_storage().resize_(0)


class ZeroAdamW(torch.optim.AdamW):
    """AdamW over `params` with its state sharded across the ranks of the
    process group.

    A `torch.optim.AdamW` over this rank's slice, so LR schedulers drive it
    as they drive the plain optimizer; `adamw` are its keyword arguments
    (`training.state.build_optimizer` sets them). Every rank must build it
    with the same parameters, in the same order and with the same values
    (train.py broadcasts rank 0's model)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], **adamw):
        self.params: List[torch.nn.Parameter] = list(params)
        if len({(p.dtype, p.device) for p in self.params}) != 1:
            raise ValueError("ZeroAdamW needs parameters of one dtype on one device")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.numels = [p.numel() for p in self.params]
        self.offsets = [0]
        for n in self.numels[:-1]:
            self.offsets.append(self.offsets[-1] + n)
        self.numel = sum(self.numels)
        self.shard_numel = math.ceil(self.numel / (self.world * ALIGN)) * ALIGN
        like = self.params[0]
        padded = self.shard_numel * self.world
        self.flat_param = torch.zeros(padded, dtype=like.dtype, device=like.device)
        self.flat_grad = torch.zeros(padded, dtype=like.dtype, device=like.device)
        with torch.no_grad():
            for p, off, n in zip(self.params, self.offsets, self.numels):
                self.flat_param[off:off + n].copy_(p.reshape(-1))
                p.data = self.flat_param[off:off + n].view_as(p)
        lo = self.rank * self.shard_numel
        self.lo, self.hi = lo, lo + self.shard_numel
        shard = torch.nn.Parameter(self.flat_param[self.lo:self.hi], requires_grad=False)
        shard.grad = self.flat_grad[self.lo:self.hi]
        super().__init__([shard], **adamw)
        self.shard = shard
        self.fsdp = False  # the parameters are sharded too; `shard_parameters` sets it
        self.zero_grad()

    def shard_parameters(self) -> None:
        """Switch to `param_sharding="fsdp"`: the slice gets storage of its
        own and the full flat parameters and gradients are freed."""
        if self.fsdp:
            return
        with torch.no_grad():
            self.shard.data = self.flat_param[self.lo:self.hi].clone()
        self.shard.grad = None
        self.fsdp = True
        self.release()

    def gather_parameters(self) -> None:
        """Under "fsdp", all-gather the slices into the full flat
        parameters, which the trained parameters are views of (a
        collective); a no-op under "replicated"."""
        if self.fsdp:
            _materialize(self.flat_param)
            dist.all_gather_into_tensor(self.flat_param, self.shard.detach())

    def release(self) -> None:
        """Under "fsdp", free the full flat parameters and gradients and the
        slice's gradient."""
        if self.fsdp:
            _free(self.flat_param)
            _free(self.flat_grad)
            self.shard.grad = None

    def _pieces(self) -> List[torch.Tensor]:
        """The parameters' pieces of this rank's slice of the gradient, for
        the gradient norm."""
        g = self.shard.grad
        return [g[max(off, self.lo) - self.lo:min(off + n, self.hi) - self.lo]
                for off, n in zip(self.offsets, self.numels)
                if max(off, self.lo) < min(off + n, self.hi)]

    # ----------------------------------------------------------- the step
    def zero_grad(self, set_to_none: bool = True) -> None:
        """Zero the flat gradient (giving it its storage back under "fsdp")
        and (re)attach each parameter's `.grad` view of it; the gradients
        are never set to None."""
        _materialize(self.flat_grad)
        self.flat_grad.zero_()
        for p, off, n in zip(self.params, self.offsets, self.numels):
            g = p.grad
            if g is None or g.data_ptr() != self.flat_grad[off:].data_ptr():
                p.grad = self.flat_grad[off:off + n].view_as(p)

    def reduce_gradients(self) -> torch.Tensor:
        """Reduce-scatter the accumulated gradients into this rank's slice,
        averaged over the ranks; returns the global L2 norm of the averaged
        gradient (the `grad_norm` metric), summed as
        `torch.nn.utils.get_total_norm` sums it: a norm per parameter (per
        piece of one, where a slice boundary cuts it), then their norm."""
        if self.shard.grad is None:  # "fsdp": the slice's own gradient
            self.shard.grad = torch.empty_like(self.shard)
        shard_grad = self.shard.grad
        dist.reduce_scatter_tensor(shard_grad, self.flat_grad)
        if self.world > 1:
            shard_grad.div_(self.world)
        sq = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(self._pieces()))).square()
        dist.all_reduce(sq)
        return sq.sqrt()

    def clip_grads_with_norm_(self, max_norm: float, total_norm: torch.Tensor) -> None:
        """`torch.nn.utils.clip_grads_with_norm_` on this rank's slice."""
        coef = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
        self.shard.grad.mul_(coef)

    @torch.no_grad()
    def step(self, closure=None):
        """AdamW on this rank's slice, then the updated slices all-gathered
        into every parameter ("replicated"), or the full parameters and
        gradients freed ("fsdp")."""
        loss = super().step(closure)
        if self.fsdp:
            self.release()
        else:
            dist.all_gather_into_tensor(self.flat_param, self.shard.detach())
        return loss

    # ----------------------------------------------------- consolidation
    def _gather(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """This rank's slice of a flat tensor, gathered: the whole flat tensor
        on the CPU of rank 0, None elsewhere."""
        parts = [torch.empty_like(t) for _ in range(self.world)] if self.rank == 0 else None
        dist.gather(t, parts, dst=0)
        if parts is None:
            return None
        flat = torch.empty(self.world * t.numel(), dtype=t.dtype)
        for i, part in enumerate(parts):
            flat[i * t.numel():(i + 1) * t.numel()].copy_(part)
        return flat

    def state_dict(self) -> Optional[Dict]:
        """Collective. On rank 0, torch AdamW's state dict over the parameter
        list (per parameter `step`, `exp_avg`, `exp_avg_sq`; one param group
        listing 0 … n−1); None on the other ranks."""
        inner = super().state_dict()
        group = {k: v for k, v in inner["param_groups"][0].items() if k != "params"}
        own = inner["state"].get(0)
        full = None
        if own is not None:
            full = {k: self._gather(own[k]) for k in ("exp_avg", "exp_avg_sq")}
        if self.rank != 0:
            return None
        state = {}
        if full is not None:  # views of the gathered flat tensors, saved once each
            for i, (p, off, n) in enumerate(zip(self.params, self.offsets, self.numels)):
                state[i] = {"step": own["step"].clone(),
                            **{k: v[off:off + n].view_as(p) for k, v in full.items()}}
        return {"state": state,
                "param_groups": [{**group, "params": list(range(len(self.params)))}]}

    def load_state_dict(self, state_dict: Dict) -> None:
        """Load torch AdamW's per-parameter state dict (written by one
        process or consolidated by `state_dict`) into this rank's slice."""
        (group,) = state_dict["param_groups"]
        ids = group["params"]
        if len(ids) != len(self.params):
            raise ValueError(f"optimizer state for {len(ids)} parameters, this run trains "
                             f"{len(self.params)}")
        state = state_dict["state"]
        own = {}
        if state:
            dev = self.flat_param.device
            # a copy: AdamW counts its step in place, and the caller's dict stays as given
            own["step"] = state[ids[0]]["step"].clone()
            for key in ("exp_avg", "exp_avg_sq"):
                flat = torch.zeros(self.shard_numel, dtype=self.flat_param.dtype, device=dev)
                for i, off, n in zip(ids, self.offsets, self.numels):
                    a, b = max(off, self.lo), min(off + n, self.hi)
                    if a < b:
                        flat[a - self.lo:b - self.lo] = state[i][key].reshape(-1)[a - off:b - off]
                own[key] = flat
        super().load_state_dict({"state": {0: own} if own else {},
                                 "param_groups": [{**group, "params": [0]}]})
