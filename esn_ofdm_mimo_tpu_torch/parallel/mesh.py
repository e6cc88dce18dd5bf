"""Rank layout for Monte-Carlo runs over several processes (port of
esn_ofdm_mimo_tpu/parallel/mesh.py).

The JAX package shards independent coherence blocks over a 1-D device mesh
(axis "trials") and psums the counters. The port runs one process a
device under `torch.distributed`: `maybe_init_distributed()` starts the
process group from the variables `torchrun` sets (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK), NCCL on the card and gloo on the CPU; `trials_mesh(n)`
returns the layout of the first n ranks, which parallel/montecarlo.py
takes as `mesh`: each rank runs its contiguous share of every round's
global block ids, and the counters are summed over the layout's ranks.
Without a process group the layout is one rank and no collective runs.

`all_sum_` and `all_gather_into` write into buffers made before any CUDA
graph capture (the fused route's accumulators and its gathered calibration
pairs; the eager route sums fresh tensors with `all_sum_` and gathers with
`all_gather_cat`): under NCCL they run on the card on the current stream,
which waits for them without a host wait; under gloo the tensors go
through the host.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

_GROUPS: dict = {}   # (world, ranks of a layout) -> its process group


class TrialsMesh(NamedTuple):
    """The ranks a Monte-Carlo run is split over."""
    size: int            # ranks in the layout (the first `size` of the world)
    rank: int            # this process's rank in it; -1 outside it
    group: Any           # their process group; None: one process, no group

    @property
    def member(self) -> bool:
        return self.rank >= 0


def device_count() -> int:
    """Devices the run spans: one a rank, the ranks of the default process
    group, or 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def maybe_init_distributed(device=None) -> bool:
    """Start the default process group from MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK (torchrun's variables) where they are set: NCCL
    where `device` is CUDA (the default), with this rank on card LOCAL_RANK
    (default: the rank modulo the cards), gloo on the CPU. Returns whether a
    group is up (also one started earlier); False without the variables."""
    if dist.is_initialized():
        return True
    if not all(os.environ.get(v) for v in ("MASTER_ADDR", "WORLD_SIZE",
                                           "RANK")):
        return False
    dev = torch.device("cuda" if device is None else device)
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def trials_mesh(n_devices: Optional[int] = None) -> TrialsMesh:
    """The layout of the first `n_devices` ranks (default: all). Every rank
    of the world must call it with the same n (it may create a process
    group); ranks beyond n get rank -1."""
    world = device_count()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"{n} ranks asked for, {world} in the world")
    if not dist.is_initialized():
        return TrialsMesh(1, 0, None)
    if n == world:
        group = dist.group.WORLD
    else:
        key = (id(dist.group.WORLD), n)     # a new world makes new groups
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(list(range(n)))
        group = _GROUPS[key]
    rank = dist.get_rank()
    return TrialsMesh(n, rank if rank < n else -1, group)


def _comm_device(mesh: TrialsMesh) -> torch.device:
    """Where the layout's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_cat(mesh: TrialsMesh, x: torch.Tensor, dim: int
                   ) -> torch.Tensor:
    """The ranks' x (of equal shapes) concatenated along `dim` in rank
    order, on x's device."""
    if mesh.group is None:
        return x
    y = x.to(_comm_device(mesh)).contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y, group=mesh.group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_sum_(mesh: TrialsMesh, x: torch.Tensor) -> torch.Tensor:
    """x (an int64 or float64 accumulator, contiguous) summed over the
    layout's ranks in place; returns x. Under NCCL it is reduced where it
    lies, on the current stream; under gloo through a host copy."""
    if mesh.group is None:
        return x
    comm = _comm_device(mesh)
    y = x if x.device == comm else x.to(comm)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    if y is not x:
        x.copy_(y)
    return x


def all_gather_into(mesh: TrialsMesh, out: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
    """The ranks' x (one shape on every rank) into out (mesh.size,
    *x.shape), contiguous, in rank order: out[r] is rank r's x. x may be
    the view out[mesh.rank] (in place). Returns out. Under NCCL it gathers
    where the tensors lie, on the current stream; under gloo through the
    host."""
    if mesh.group is None:
        if x.data_ptr() != out[0].data_ptr():
            out[0].copy_(x)
        return out
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    comm = _comm_device(mesh)
    # gloo copies its input into its slot of out: never from out itself
    src = (x if comm.type == "cuda" else x.to(comm, copy=True)).reshape(-1)
    dst = out if out.device == comm else torch.empty(
        out.shape, dtype=out.dtype, device=comm)
    gather(dst.view(-1), src, group=mesh.group)
    if dst is not out:
        out.copy_(dst)
    return out
