"""The vertex-partition placement: which process group and which device
each shard of a partitioned graph runs on.

The counterpart of ``repro.dist.sharding.shard_mesh``. A JAX mesh is one
program over many devices; here there is one process per shard (SPMD over
``torch.distributed``), so the "mesh" is the process group plus this
process's rank and device. The caller starts the processes and initialises
the group (``dist.init_process_group`` with its address, world size and
rank); only that call knows the backend — gloo for CPU tensors and for
several ranks on one card, NCCL for one rank per card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.graph.structure import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """One process's place in a partitioned run: the group its collectives
    go over (``None``: one shard, no collective), the number of shards,
    this process's shard and the device its blocks live on."""

    group: Optional[object]
    n_shards: int
    rank: int
    device: torch.device


def shard_mesh(n_shards: Optional[int] = None, group=None, device="cuda") -> ShardMesh:
    """The placement of one shard per rank of ``group``.

    ``group`` defaults to the default process group when one is
    initialised, else to none (one shard, run in the calling process).
    ``n_shards`` defaults to the group's size; one shard runs locally in
    every calling process, more shards than ranks raise, as the JAX
    ``shard_mesh`` does for more shards than devices, and any other count
    needs a group of that many ranks (``dist.new_group``). Shard ``r`` runs
    on ``cuda:{r % device_count}`` unless ``device`` names another;
    ``"cuda"`` without a card raises.
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    size = 1 if group is None else dist.get_world_size(group)
    if n_shards is None:
        n_shards = size
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if n_shards > size:
        raise ValueError(
            f"n_shards={n_shards} exceeds the process group's {size} ranks"
        )
    if n_shards == 1:
        group, rank = None, 0
    elif n_shards != size:
        raise ValueError(
            f"n_shards={n_shards} needs a group of {n_shards} ranks, not "
            f"{size}: pass group=dist.new_group(...)"
        )
    else:
        rank = dist.get_rank(group)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return ShardMesh(group=group, n_shards=n_shards, rank=rank, device=dev)
