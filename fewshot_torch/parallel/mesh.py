"""The data mesh: the episode meta-batch split over torch.distributed ranks.

Port of ``fewshot/parallel/mesh.py``.  JAX's 1-D ``data`` mesh spans a
host's chips inside one process; here each rank is a process on its own
card (``distributed.py``), and the mesh is the process group.  Parameters
are replicated; each rank draws its B/W episodes from its own generator
(``rank_seed``), computes local (grads, ce_sum, token_count), and the three
are summed over the world in one all-reduce of one flat bucket
(``all_reduce_sum``).  Dividing the summed CE by the summed count after the
reduction keeps the masked NLL exact under ragged lengths, and the apply
that follows is the same arithmetic on every rank, so the parameters stay
bit-identical across ranks.

The all-reduce is synchronous: NCCL orders it against the caller's current
stream, on which the kernels launched, so the apply reads the reduced sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """This process's place in the data mesh."""
    rank: int
    world: int


def make_mesh() -> Mesh | None:
    """The mesh of the initialized process group, or None where there is
    none (one process: nothing is reduced)."""
    if not dist.is_initialized():
        return None
    return Mesh(dist.get_rank(), dist.get_world_size())


def world_of(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.world


def local_batch(batch_size: int, mesh: Mesh | None) -> int:
    """The episodes one rank draws of a global batch."""
    n = world_of(mesh)
    if batch_size % n:
        raise ValueError(
            f"batch_size {batch_size} not divisible by {n} processes")
    return batch_size // n


def rank_seed(seed: int, mesh: Mesh | None) -> int:
    """The seed of a rank's generator: `seed` itself in a world of one (the
    single-process bits), else one drawn from SeedSequence([seed, rank]),
    so the ranks draw different episodes."""
    if world_of(mesh) == 1:
        return seed
    return int(np.random.SeedSequence([seed, mesh.rank]).generate_state(1)[0])


def all_reduce_sum(tensors: list) -> list:
    """The sums over the world of same-dtype tensors, by one all-reduce of
    their concatenation (copied in and out: exact in a world of one).
    Each call adds one to ``all_reduce_sum.calls``."""
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("all_reduce_sum takes tensors of one dtype")
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    all_reduce_sum.calls += 1
    dist.all_reduce(flat)
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos:pos + t.numel()].view(t.shape))
        pos += t.numel()
    return out


all_reduce_sum.calls = 0


def sum_over(mesh: Mesh | None, tensors) -> tuple:
    """The tensors summed over the mesh (themselves with no mesh)."""
    return tuple(tensors) if mesh is None else tuple(
        all_reduce_sum(list(tensors)))


def shard_step(mesh: Mesh | None, local_fn):
    """Wrap ``local_fn(*args) -> (grads dict, ce_sum, count)`` so that all
    three come back summed over the mesh (one all-reduce a call); with no
    mesh, local_fn itself."""
    if mesh is None:
        return local_fn

    def wrapped(*args):
        grads, total, count = local_fn(*args)
        names = list(grads)
        summed = all_reduce_sum([grads[k] for k in names] + [total, count])
        return dict(zip(names, summed[:-2])), summed[-2], summed[-1]
    return wrapped


def gather_objects(obj, mesh: Mesh | None) -> list:
    """[obj of rank 0, ..., obj of rank W-1] on every rank."""
    if mesh is None:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None:
        dist.barrier()
