"""The process group of a multi-GPU run (counterpart of the JAX CLI's
distributed initialisation, train.py:78-88, and of the "data" axis of
hi3d_tpu/parallel/mesh.py's `get_mesh`).

One process per GPU, started by torchrun, which sets `RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`:

    torchrun --nproc_per_node N -m hi3d_tpu_torch.train --base configs/train-v01.yaml

`init` reads them and joins the group: NCCL for a CUDA device (the process
takes `cuda:LOCAL_RANK`), gloo for the CPU. Without `WORLD_SIZE` it does
nothing and the run is one process (world 1). With `WORLD_SIZE` set, a group
that cannot be joined is an error: there is no fallback to another backend or
to one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Tuple

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)  # a collective that waits longer raises


def init(device: str = "cuda") -> Tuple[torch.device, bool]:
    """(this process's device, whether this call created the group).

    Under torchrun (`WORLD_SIZE` set) joins the group from the environment,
    unless one is already initialised; a CUDA `device` becomes
    `cuda:LOCAL_RANK` and is made current. Otherwise returns `device` as
    given and creates nothing."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev, False
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if initialized():
        return dev, False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            timeout=TIMEOUT,
                            device_id=dev if dev.type == "cuda" else None)
    return dev, True


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of a tensor over the ranks (the tensor itself in one
    process)."""
    if not initialized():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / world()


def any_over_ranks(flag: bool, device: torch.device) -> bool:
    """True on every rank when `flag` is true on some rank."""
    if not initialized():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers, copied to every rank."""
    if not initialized():
        return
    with torch.no_grad():
        for t in module.state_dict(keep_vars=True).values():
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=0)


def broadcast_object(obj):
    """Rank 0's value of a picklable object, on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
