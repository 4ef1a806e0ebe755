"""The process group of a sharded run (port of tmgcn_tpu.parallel.distributed).

One process per device, as PyTorch runs multi-device work: on NVIDIA cards
NCCL, each process on ``cuda:{LOCAL_RANK}``, launched by ``torchrun``; on
the CPU gloo. ``initialize`` reads the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); without
it, it makes a world of one process over an in-memory store, so a single
process and the tests need no launcher.

There is no fallback: a CUDA run with more processes than visible cards
raises (NCCL refuses two ranks on one card anyway), and a run never drops
to gloo or to the CPU.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# Every group's timeout: a dead rank fails the run instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=60)


def initialize(device: str | torch.device) -> torch.device:
    """Join (or make) the world of this run; returns this rank's device.

    ``device``: "cuda" (NCCL, this rank's card ``cuda:{LOCAL_RANK}``) or
    "cpu" (gloo). Joining twice is a no-op; a world already made with the
    other backend raises.
    """
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    env = os.environ
    rank, world = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
    local = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if local_world > n:
            raise RuntimeError(
                f"{local_world} processes on this host need {local_world} GPUs, one "
                f"each; {n} visible (a mesh never puts two ranks on one card)"
            )
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, this run asks for "
                f"{backend} ({device.type})"
            )
        return device
    if "MASTER_ADDR" in env and "RANK" in env:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
    return device


def shutdown() -> None:
    """Leave the world, if there is one (the end of a launched run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def runtime_info() -> dict:
    """Process/device topology summary for logs (the JAX package's keys)."""
    nccl = dist.get_backend() == "nccl"
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": torch.cuda.device_count() if nccl else 1,
        "global_devices": dist.get_world_size(),
        "platform": "gpu" if nccl else "cpu",
    }
