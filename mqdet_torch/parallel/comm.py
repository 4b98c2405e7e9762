"""Cross-process communication (counterpart of `mqdet_tpu/parallel/comm.py`;
reference maskrcnn_benchmark/utils/comm.py): the world size and rank, a
barrier, the all-gather of picklable objects (the evaluation's and the
bank's merges), `reduce_dict` of the logged losses, the tensor sum of the
gradients and the loss normalisers, and `init_distributed` for a process
that `torchrun` started.

The port is data-parallel the way the reference is: one process per card,
launched by `torchrun`, each on `cuda:LOCAL_RANK`. `mqdet_tpu/parallel/
mesh.py` has no counterpart: the JAX package shards one program's batch
over a device mesh and lets XLA insert the collectives; here every process
runs the whole step on its share of the batch and the train step sums the
fp32 gradients itself (`engine/train.py`).

Outside a process group, or in a group of one, every function here is the
identity (`all_gather` returns `[data]`) and calls no collective.

Backends: NCCL on cards, gloo on the CPU, or gloo on cards where two ranks
share one card (NCCL refuses two ranks on one device). Gloo runs its
all-reduce on CUDA tensors by staging them through host memory; NCCL keeps
them on the card. `all_gather_object` pickles through host memory under
gloo, and through a byte tensor on the rank's current card under NCCL.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List

import torch
import torch.distributed as dist


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier of every rank (none in a world of one)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """Every rank's picklable `data`, in rank order."""
    if get_world_size() == 1:
        return [data]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out


def broadcast_object(data: Any, src: int = 0) -> Any:
    """Rank `src`'s picklable `data` on every rank."""
    if get_world_size() == 1:
        return data
    box = [data]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` summed over the ranks, in place; returns it."""
    if get_world_size() > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def reduce_dict(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar tensors summed over the ranks by one all-reduce, in sorted key
    order on the first value's device (each rank's losses are its share of
    the global loss, so the sum is the global loss)."""
    if get_world_size() == 1:
        return d
    keys = sorted(d)
    vec = torch.stack([torch.as_tensor(d[k]).float().reshape(()) for k in keys])
    all_reduce_sum(vec)
    return dict(zip(keys, vec.unbind()))


def init_distributed(device="cuda", backend=None, timeout_s: float = 1800.0) -> torch.device:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment) and return the
    process's device: `cuda:LOCAL_RANK`, made current, for a card; the CPU
    otherwise. `backend` defaults to NCCL on a card and gloo on the CPU.
    A collective that waits longer than `timeout_s` raises. Joining twice
    returns the device without a second group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method="env://",
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    return dev


def launched_by_torchrun() -> bool:
    """Whether the environment describes a group of more than one process."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1
