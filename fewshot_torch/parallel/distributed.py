"""Multi-process initialization from the JAX package's variables.

Port of ``fewshot/parallel/distributed.py``.  JAX runs one process per host
over all its chips; the port runs one process per card, as PyTorch does.
Launch process i of N with

    FEWSHOT_COORDINATOR=<host0>:<port> FEWSHOT_NUM_PROCESSES=<N> \\
    FEWSHOT_PROCESS_ID=<i> python -m fewshot_torch.cli train ...

and ``maybe_initialize`` (called by every CLI command before it touches a
device) joins ``torch.distributed`` at ``tcp://<coordinator>``: NCCL when
the device is CUDA, gloo on the CPU, the process's card ``cuda:{rank %
device_count}``.  Without the variables the world is one process and
nothing calls ``torch.distributed``.
"""

from __future__ import annotations

import atexit
import os

import torch
import torch.distributed as dist

from fewshot_torch.device import resolve_device


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def maybe_initialize(device: torch.device | str | None = None) -> bool:
    """Join the process group the FEWSHOT_* variables describe, if they
    are set (once a process; later calls return True)."""
    coord = os.environ.get("FEWSHOT_COORDINATOR")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    world = int(os.environ["FEWSHOT_NUM_PROCESSES"])
    rank = int(os.environ["FEWSHOT_PROCESS_ID"])
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coord}", world_size=world,
                            rank=rank)
    atexit.register(_shutdown)
    return True


def process_device(device: torch.device | str | None = None) -> torch.device:
    """The device this process runs on: a bare ``cuda`` becomes the
    process's own card, ``cuda:{rank % device_count}``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda",
                            dist.get_rank() % torch.cuda.device_count())
    return dev


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns logging, printing and writing."""
    return not dist.is_initialized() or dist.get_rank() == 0
