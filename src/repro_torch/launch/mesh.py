"""Mesh construction: the JAX package's ``repro.launch.mesh`` on
``torch.distributed``.

A mesh (``dist.sharding.Mesh``) maps each named axis to its size, as a
JAX mesh's ``.shape`` does, so the sharding rules run unchanged whatever
the process count. It holds a torch ``DeviceMesh`` only when a process
group of exactly that many ranks is initialised (the caller starts the
processes and calls ``dist.init_process_group``); otherwise it is one rank
(size 1: no collective) or a mesh the rules only reason about (the
production meshes in one process, as JAX's dry-run's fake devices).
Functions, so that importing this module touches no process group.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips a pod; 2 pods = 512 chips (the JAX package's TPU
    v5e pod slice shapes)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` (elastic restarts re-shape here).
    With a process group of ``prod(shape)`` ranks it holds a ``DeviceMesh``
    over it, and this rank's device is ``cuda:{rank % device_count}`` (or
    ``device`` if it names an index or the CPU)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    size = math.prod(shape)
    dev = torch.device(device)
    device_mesh = None
    if (size > 1 and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == size):
        from torch.distributed.device_mesh import init_device_mesh

        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        device_mesh = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return Mesh(shape=dict(zip(axes, shape)), device_mesh=device_mesh, device=dev)
