"""Sharding rules, the active-mesh context and the vertex-partition
placement — the distribution layer of the port.

The JAX package's ``repro.dist.sharding`` on ``torch.distributed``. JAX
runs one program over a mesh of devices; the port runs one process per
rank (SPMD), so a mesh here (:class:`Mesh`) is the JAX mesh's axis → size
map plus, when a process group of that many ranks exists, the torch
``DeviceMesh`` over it. The rules read only ``mesh.shape``, so they run
unchanged in one process over any mesh size, as the JAX rules run over
the dry-run's fake meshes.

Physical mesh axes (see ``repro_torch.launch.mesh``): ``pod`` (inter-pod
data parallelism), ``data`` (data parallelism / the FSDP shard axis) and
``model`` (tensor/expert parallelism). Logical axes: :data:`BATCH`, the
data-parallel group (``pod`` × ``data``), and :data:`ALL`, every mesh axis
flattened (the edge/node dimension of graph workloads).

A spec (:class:`PartitionSpec`) is a tuple with one entry per dimension —
``None`` (replicated), an axis name, or a tuple of names — and compares
equal, entry for entry, to JAX's ``PartitionSpec``. Every derivation goes
through :func:`_maybe`, which drops an axis from a dimension it does not
evenly divide. A :class:`NamedSharding` is a spec on a mesh; its
``placements`` are the DTensor placements (``Shard(d)`` / ``Replicate()``
per mesh dimension). :func:`device_put` applies them only on a mesh of
more than one rank; on one rank it moves the tensor to the mesh's device
and makes no collective.

Param-spec policy (``lm_param_spec``, keyed by the JAX tree's param path;
the port's LM parameters are renested by ``models.transformer.model.
params_tree``):

=====================  ======================  ===========================
path                   shape                   spec (fsdp mode)
=====================  ======================  ===========================
``embed``/``unembed``  ``[V, D]``              ``P("model", "data")``
``layers/wq|wk|wv``    ``[L, D, H·hd]``        ``P(None, "data", "model")``
``layers/wo``          ``[L, H·hd, D]``        ``P(None, "model", "data")``
``layers/ffn/w1|w3``   ``[L, D, F]``           ``P(None, "data", "model")``
``layers/ffn/w2``      ``[L, F, D]``           ``P(None, "model", "data")``
``layers/moe/w*``      ``[L, E, D, F]``        ``P(None, "model", "data", None)``
``layers/moe/router``  ``[L, D, E]``           ``P()``
norms / biases         ``[L, D]`` / ``[D]``    ``P()``
=====================  ======================  ===========================

``zero1`` mode keeps only the ``model`` shards on the stored params.

The vertex-partition half (:func:`shard_mesh`, :class:`ShardMesh`) places
one shard of a partitioned graph per rank of a process group; the caller
starts the processes and initialises the group (``dist.init_process_
group`` with its address, world size and rank); only that call knows the
backend — gloo for CPU tensors and for several ranks on one card, NCCL for
one rank per card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.graph.structure import resolve_device

# --------------------------------------------------------------------------
# logical axes

ALL = "__all__"  #: every mesh axis, flattened (graph edge/node dims)
BATCH = "__batch__"  #: the data-parallel group (pod × data)
SHARD = "shard"  #: the 1-D vertex-partition axis (``repro_torch.graph.partition``)

#: physical axes belonging to the data-parallel group, in mesh order
_DATA_AXES = ("pod", "data")
#: every physical axis this layer knows about, in mesh order
_MESH_AXES = ("pod", "data", "model")

_AxisEntry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per dimension: ``None``, an axis name or a tuple of names.
    A tuple, so it compares equal to JAX's ``PartitionSpec`` entry for
    entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(eq=False)
class Mesh:
    """A named mesh: ``shape`` maps each axis to its size, in mesh order (as
    JAX's ``Mesh.shape``). ``device_mesh`` is the torch ``DeviceMesh`` over
    the process group when one of ``size`` ranks exists, else ``None``
    (one rank, or a mesh the rules only reason about). ``device`` is where
    this process's tensors live (resolved when a tensor is placed)."""

    shape: Dict[str, int]
    device_mesh: Optional[Any] = None
    device: Any = "cuda"

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` on ``mesh``, as JAX's ``NamedSharding``."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """The DTensor placements: per mesh axis, ``Shard(d)`` for the
        dimension ``d`` whose entry names it, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec) if axis in _names(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def _names(entry: _AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# --------------------------------------------------------------------------
# active mesh context

_ACTIVE_MESH: Optional[Mesh] = None


def activate(mesh: Mesh) -> Mesh:
    """Make ``mesh`` the process-wide active mesh (``constrain`` reads it)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return mesh


def deactivate() -> None:
    """Clear the active mesh (idempotent)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = None


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


# --------------------------------------------------------------------------
# axis resolution helpers


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Physical axes of the data-parallel group present on ``mesh``."""
    return tuple(a for a in _DATA_AXES if a in mesh.shape)


def all_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Every known physical axis present on ``mesh``, in mesh order."""
    return tuple(a for a in _MESH_AXES if a in mesh.shape)


def _collapse(entry: Sequence[str]) -> _AxisEntry:
    """() → None, (a,) → a, (a, b, ...) → tuple (PartitionSpec idiom)."""
    entry = tuple(entry)
    if not entry:
        return None
    if len(entry) == 1:
        return entry[0]
    return entry


def _resolve(axes: Sequence[Any], mesh: Mesh) -> Tuple[_AxisEntry, ...]:
    """Map logical entries (ALL / BATCH) to physical axis entries."""
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif a == ALL:
            out.append(_collapse(all_axes(mesh)))
        elif a == BATCH:
            out.append(_collapse(data_axes(mesh)))
        else:
            out.append(a if isinstance(a, tuple) else str(a))
    return tuple(out)


def axis_size(entry: _AxisEntry, mesh: Mesh) -> int:
    """Product of mesh-axis sizes named by ``entry`` (1 for ``None``)."""
    n = 1
    for name in _names(entry):
        n *= mesh.shape[name]
    return n


def _maybe(axes: Sequence[_AxisEntry], shape: Sequence[int], mesh: Mesh) -> PartitionSpec:
    """A spec over ``axes``, dropping entries that cannot apply: an entry
    is kept only if every named axis exists on ``mesh`` and the product of
    their sizes evenly divides the dimension; entries beyond ``len(shape)``
    are truncated. This makes every rule here total."""
    out = []
    for i, entry in enumerate(axes[: len(shape)]):
        if entry is None or any(n not in mesh.shape for n in _names(entry)):
            out.append(None)
        elif shape[i] % axis_size(entry, mesh) != 0:
            out.append(None)
        else:
            out.append(entry)
    return P(*out)


def constrain(x: torch.Tensor, axes: Sequence[Any]) -> torch.Tensor:
    """``x`` unchanged with no active mesh or a one-rank mesh, as JAX's
    ``constrain`` is a no-op there. On a multi-rank mesh it raises: the
    models on the mesh are the next slice (ROADMAP A8c)."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.size == 1:
        return x
    raise NotImplementedError(
        f"constrain on a {mesh.size}-rank mesh: activation sharding is not ported"
    )


# --------------------------------------------------------------------------
# parameter sharding rules (path-keyed)

#: param names that are always replicated (norm gains, biases, scalars)
_REPLICATED_NAMES = frozenset(
    {"ln1", "ln2", "ln_f", "q_norm", "k_norm", "bq", "bk", "bv", "b",
     "router", "step"}
)
#: column-parallel matmuls: reduction dim → data (FSDP), output dim → model
_COL_PARALLEL = frozenset({"wq", "wk", "wv", "w1", "w3"})
#: row-parallel matmuls: input dim → model, output dim → data (FSDP)
_ROW_PARALLEL = frozenset({"wo", "w2"})


def _drop_data(spec: PartitionSpec) -> PartitionSpec:
    """zero1 mode: strip the data-group axes (params stay model-sharded)."""
    return P(*(_collapse(n for n in _names(e) if n not in _DATA_AXES) for e in spec))


def lm_param_spec(path: str, leaf, mesh: Mesh, mode: str = "fsdp") -> PartitionSpec:
    """Spec of one LM param, keyed by its ``/``-joined JAX path; ``leaf``
    needs only ``.shape``. See the module docstring for the policy."""
    if mode not in ("fsdp", "zero1"):
        raise ValueError(f"unknown param mode {mode!r}")
    shape = tuple(leaf.shape)
    name = path.rsplit("/", 1)[-1]
    dat = _collapse(data_axes(mesh))

    if name in _REPLICATED_NAMES or len(shape) <= 1:
        return P()
    if name in ("embed", "unembed"):
        spec = _maybe(("model", dat), shape, mesh)
    elif "moe" in path.split("/") and name in ("w1", "w2", "w3") and len(shape) >= 4:
        lead = (None,) * (len(shape) - 3)
        spec = _maybe(lead + ("model", dat, None), shape, mesh)
    elif name in _COL_PARALLEL:
        lead = (None,) * (len(shape) - 2)
        spec = _maybe(lead + (dat, "model"), shape, mesh)
    elif name in _ROW_PARALLEL:
        lead = (None,) * (len(shape) - 2)
        spec = _maybe(lead + ("model", dat), shape, mesh)
    else:
        return P()
    if mode == "zero1":
        spec = _drop_data(spec)
    return spec


def gnn_param_spec(path: str, leaf, mesh: Mesh, mode: str = "fsdp") -> PartitionSpec:
    """GNN params are small relative to node/edge state: replicated."""
    del path, leaf, mesh, mode
    return P()


def recsys_param_spec(path: str, leaf, mesh: Mesh, mode: str = "fsdp") -> PartitionSpec:
    """RecSys: the embedding tables' vocab rows over the whole mesh, the
    MLP replicated."""
    del mode
    shape = tuple(leaf.shape)
    name = path.rsplit("/", 1)[-1]
    if "embed" in name and len(shape) >= 2:
        lead = (None,) * (len(shape) - 2)
        return _maybe(lead + (_collapse(all_axes(mesh)), None), shape, mesh)
    return P()


_PARAM_RULES = {
    "lm": lm_param_spec,
    "gnn": gnn_param_spec,
    "recsys": recsys_param_spec,
}


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists (``None`` stays),
    paths ``/``-joined as JAX's key paths."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(kind: str, params, mesh: Mesh, mode: str = "fsdp"):
    """Tree of :class:`NamedSharding` matching ``params`` (the JAX nesting),
    per the family's rules; ``kind`` ∈ {"lm", "gnn", "recsys"}."""
    rule = _PARAM_RULES[kind]
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, rule(path, leaf, mesh, mode=mode)), params)


# --------------------------------------------------------------------------
# batch / activation shardings


def lm_batch_spec(mesh: Mesh, batch: int) -> PartitionSpec:
    """Spec for a ``[B, ...]`` token-stream array: batch over the DP group."""
    return _maybe((_collapse(data_axes(mesh)),), (batch,), mesh)


def lm_cache_spec(mesh: Mesh, cfg, batch: int, cache: int) -> PartitionSpec:
    """Spec for the stacked KV cache ``[L, B, C, Hkv, hd]``: batch over the
    DP group, the cache's sequence dim over ``model``."""
    shape = (cfg.n_layers, batch, cache, cfg.n_kv_heads, cfg.head_dim)
    return _maybe((None, _collapse(data_axes(mesh)), "model", None, None), shape, mesh)


def batch_shardings(kind: str, batch_specs, mesh: Mesh):
    """Tree of :class:`NamedSharding` for model inputs: ``"lm"`` leading dim
    over the data-parallel group; ``"gnn"`` / ``"recsys"`` over every mesh
    axis."""
    entries = {
        "lm": _collapse(data_axes(mesh)),
        "gnn": _collapse(all_axes(mesh)),
        "recsys": _collapse(all_axes(mesh)),
    }
    if kind not in entries:
        raise ValueError(
            f"unknown batch kind {kind!r}; expected one of {sorted(entries)}"
        )
    entry = entries[kind]

    def leaf_sharding(_, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:  # scalars
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, _maybe((entry,), shape, mesh))

    return _map_with_path(leaf_sharding, batch_specs)


def replicated(x, mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (optimizer step counters, scalars)."""
    del x
    return NamedSharding(mesh, P())


# --------------------------------------------------------------------------
# placing tensors


def _local_slices(shape: Sequence[int], sharding: NamedSharding, coordinate) -> tuple:
    """The slice of each dimension of a ``shape`` array that the rank at
    ``coordinate`` (its index along each mesh axis) holds: a tuple entry
    splits its dimension row-major over the named axes."""
    mesh = sharding.mesh
    axes = mesh.axis_names
    out = []
    for dim, n in enumerate(shape):
        names = _names(sharding.spec[dim]) if dim < len(sharding.spec) else ()
        index, parts = 0, 1
        for name in names:
            size = mesh.shape[name]
            index = index * size + coordinate[axes.index(name)]
            parts *= size
        chunk = n // parts
        out.append(slice(index * chunk, (index + 1) * chunk))
    return tuple(out)


def device_put(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the logical array) placed by ``sharding``: on a one-rank mesh
    the tensor on the mesh's device; on a multi-rank mesh a DTensor holding
    this rank's slice (no collective: every rank holds ``x``)."""
    mesh = sharding.mesh
    dev = resolve_device(mesh.device)
    if mesh.device_mesh is None:
        if mesh.size > 1:
            raise ValueError(f"a mesh of {mesh.size} ranks needs a process group of "
                             f"that size to place tensors")
        return x.to(dev)
    from torch.distributed.tensor import DTensor

    for entry in sharding.spec:
        names = _names(entry)
        if list(names) != sorted(names, key=mesh.axis_names.index):
            raise NotImplementedError(f"spec entry {entry} is not in mesh order")
    coord = mesh.device_mesh.get_coordinate()
    local = x[_local_slices(x.shape, sharding, coord)].contiguous().to(dev)
    return DTensor.from_local(local, mesh.device_mesh, sharding.placements, run_check=False)


def spec_of(x) -> PartitionSpec:
    """The spec of a DTensor: each dimension's mesh axes, in mesh order."""
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names or tuple(
        f"dim{i}" for i in range(x.device_mesh.ndim))
    per_dim = [[] for _ in range(x.ndim)]
    for name, placement in zip(names, x.placements):
        if isinstance(placement, Shard):
            per_dim[placement.dim].append(name)
    return P(*(_collapse(n) for n in per_dim))


# --------------------------------------------------------------------------
# vertex-partition placement (repro_torch.graph.partition)


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


def vertex_partition_spec(ndim: int = 2) -> PartitionSpec:
    """Spec for a ``[S, ...]`` per-shard block array: leading dim over
    :data:`SHARD`, everything else replicated."""
    return P(SHARD, *(None,) * (ndim - 1))


def vertex_partition_shardings(tree, mesh: Mesh):
    """Tree of :class:`NamedSharding` for partitioned per-shard arrays:
    leading dims that the shard axis divides shard over :data:`SHARD`,
    everything else replicates."""

    def leaf_sharding(_, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, _maybe((SHARD,), shape, mesh))

    return _map_with_path(leaf_sharding, tree)
