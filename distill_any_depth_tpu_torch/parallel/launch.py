"""Process-group set-up and the cross-process helpers.

Counterpart of distill_any_depth_tpu/parallel/launch.py
(``initialize_distributed``, ``process_index``, ``process_count``,
``is_main_process``, ``all_gather_array``, ``shared_random_seed``,
``synchronize``) over ``torch.distributed``: one process per device, started
by ``torchrun``, which sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``. NCCL joins CUDA devices and gloo the
CPU. Every helper degrades to single-process semantics when no process group
is initialized, the same contract as the JAX package's.

The helpers move data with ``broadcast`` and ``all_reduce`` alone, the two
collectives gloo also runs on CUDA tensors, so that two ranks may share one
card over gloo (NCCL refuses two ranks of one communicator on one device).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["TORCHRUN_ENV", "launched", "initialize_distributed", "process_group", "local_device",
           "process_index", "process_count", "is_main_process", "all_gather_array", "shared_random_seed", "synchronize"]

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def launched() -> bool:
    """Whether ``torchrun``'s environment is set."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """``device``, with a CUDA device that names no index placed on
    ``cuda:{LOCAL_RANK}`` under ``torchrun`` (``cuda:0`` otherwise)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def initialize_distributed(backend: str | None = None,
                           device: str | torch.device = "cuda") -> bool:
    """Join the process group that ``torchrun``'s environment describes; a
    no-op without it, or when a group is already initialized. ``backend``
    defaults to NCCL for a CUDA ``device`` and gloo for the CPU (two ranks
    that share one card pass ``"gloo"``). Returns whether a process group is
    active."""
    if dist.is_initialized() or not launched():
        return dist.is_initialized()
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return True


@contextlib.contextmanager
def process_group(device: str | torch.device = "cuda"):
    """``initialize_distributed`` for the span of a command-line run: a group
    that it creates is destroyed at the end (one that was there stays)."""
    created = not dist.is_initialized() and initialize_distributed(device=device)
    try:
        yield
    finally:
        if created:
            dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def _comm_device() -> torch.device:
    """Where the collectives take their tensors: the current card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_array(x) -> np.ndarray:
    """A host array of equal shape on every process, stacked on a new
    leading axis in rank order (``x[None]`` single-process)."""
    x = np.asarray(x)
    if process_count() == 1:
        return x[None]
    dev = _comm_device()
    out = torch.empty((process_count(), *x.shape), dtype=torch.from_numpy(x).dtype, device=dev)
    out[process_index()] = torch.from_numpy(np.ascontiguousarray(x))
    for r in range(process_count()):
        dist.broadcast(out[r], src=r)
    return out.cpu().numpy()


def shared_random_seed(seed: int | None = None) -> int:
    """One seed agreed on by every process: rank 0's ``seed`` (or a random
    draw when ``seed`` is None)."""
    local = int(np.uint32(seed if seed is not None else np.random.randint(2 ** 31)))
    if process_count() == 1:
        return local
    t = torch.tensor([local], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def synchronize() -> None:
    """A barrier across every process."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
