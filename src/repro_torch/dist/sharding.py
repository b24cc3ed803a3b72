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

A graph's node and edge dimensions (:data:`ALL`) have a carrier of their
own: a tensor whose rows are split over every rank is a flat DTensor,
``Shard(0)`` on :func:`flat_mesh` (the mesh flattened row-major), whose
local tensor holds this rank's rows; the dense work on it runs on that
local tensor (:func:`rowwise`). :func:`constrain` to ``(ALL, ...)`` cuts
a whole tensor to this rank's rows and gathers a flat one whole where the
mesh does not divide its rows, as JAX's ``_maybe`` leaves it replicated.

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

FSDP shards (:func:`shard_of`, :func:`unshard`, :class:`Gather`): a rank
holds a leaf as its slice under the leaf's ``NamedSharding`` — the shape
JAX's ``NamedSharding.shard_shape`` gives (:func:`shard_shape`) — and a
model gathers it whole where it uses it (``dist.collectives.
all_gather_dim`` over each sharded dimension's axes), the gather's
backward handing the shard its gradient. A dimension split over ``model``
may stay split (``Gather.of``'s ``keep``): an LM's tensor parallelism,
dense or MoE (:func:`model_axis`), uses each rank's ``model`` block where
it is, as JAX's specs lay it out.

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

from repro_torch.dist import collectives
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
    #: process groups over axes and the flattened DeviceMesh, made at first use
    _cache: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False)

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
_BATCH_SPLIT = False


def activate(mesh: Mesh, batch_split: bool = False) -> Mesh:
    """Make ``mesh`` the process-wide active mesh (``constrain`` reads it).
    ``batch_split``: each rank already holds only its data shard's rows (a
    data-parallel step), so a region runs over the ``model`` axis alone
    (:func:`batch_split`; the MoE's expert parallelism)."""
    global _ACTIVE_MESH, _BATCH_SPLIT
    _ACTIVE_MESH, _BATCH_SPLIT = mesh, batch_split
    return mesh


def deactivate() -> None:
    """Clear the active mesh (idempotent)."""
    global _ACTIVE_MESH, _BATCH_SPLIT
    _ACTIVE_MESH, _BATCH_SPLIT = None, False


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def batch_split() -> bool:
    """Whether the active mesh's data axes split the batch already."""
    return _BATCH_SPLIT


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The active mesh's ``model`` axis as this rank sees it: the process
    group of the ranks that share its data coordinates, their number and
    this rank's index among them (tensor parallelism)."""

    group: Any
    size: int
    rank: int

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` (split evenly over the axis, as
        :func:`shard_of` splits a dimension whose entry names ``model``)."""
        if n % self.size:
            raise NotImplementedError(f"a dimension of {n} on a model axis of {self.size}: "
                                      f"tensor parallelism needs it to divide")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def model_axis() -> Optional[ModelAxis]:
    """The active mesh's :class:`ModelAxis` when it has more than one rank
    and runs on a process group, else ``None`` (no tensor parallelism)."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.device_mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    group = axis_group(mesh, ("model",))
    return ModelAxis(group, mesh.shape["model"], dist.get_rank(group))


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
    """``with_sharding_constraint`` against the active mesh, which never
    changes a value. Without a multi-rank mesh on a process group, ``x``
    as it is. A DTensor on the mesh's ``DeviceMesh`` is laid out by the
    spec, after ``_maybe`` drops the indivisible entries: gathered whole
    (``dist.collectives.full_tensor``) and placed, unless it has the spec's
    placements already. The graph dimensions (:func:`flat_mesh`): where
    the spec splits the rows over every axis (:data:`ALL`) and nothing
    else, a plain tensor (every rank holds the global value) becomes this
    rank's block of its rows (:func:`shard_rows`: a view, no collective)
    and a flat DTensor stays as it is; where it does not — the mesh does
    not divide the rows, or another spec — a flat DTensor is gathered
    whole (:func:`whole`), as JAX's ``_maybe`` leaves it replicated. Any
    other plain tensor comes back unchanged."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.size == 1 or mesh.device_mesh is None:
        return x
    spec = _maybe(_resolve(axes, mesh), x.shape, mesh)
    if _is_dtensor(x) and x.device_mesh is mesh.device_mesh:
        sharding = NamedSharding(mesh, spec)
        if tuple(x.placements) == sharding.placements:
            return x
        return device_put(collectives.full_tensor(x), sharding)
    rows = (len(spec) > 0 and spec[0] == _collapse(all_axes(mesh))
            and all(e is None for e in spec[1:]))
    if is_flat(x):
        return x if rows else whole(x)
    return shard_rows(x, mesh) if rows else x


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


# --------------------------------------------------------------------------
# process groups of a multi-rank mesh


def _need_ranks(mesh: Mesh):
    if mesh.device_mesh is None:
        raise ValueError(f"a mesh of {mesh.size} ranks needs a process group of that "
                         f"size to run on")


def axis_group(mesh: Mesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's coordinates on
    every axis but ``axes``: the group a collective over ``axes`` runs on.
    Its ranks are in row-major order over ``axes`` (mesh order), so a rank's
    place in it is its flattened index over them, as JAX's
    ``axis_index`` flattens a tuple of axes. Made once per mesh (every rank
    makes every group, in the same order, at its first use)."""
    _need_ranks(mesh)
    names = mesh.axis_names
    key = tuple(a for a in names if a in axes)
    groups = mesh._cache
    if key not in groups:
        if len(key) == len(names):
            groups[key] = dist.group.WORLD
        else:
            import numpy as np

            ranks = np.arange(mesh.size).reshape([mesh.shape[a] for a in names])
            inner = [names.index(a) for a in key]
            outer = [i for i in range(len(names)) if i not in inner]
            lists = ranks.transpose(outer + inner).reshape(-1, math.prod(
                mesh.shape[a] for a in key)).tolist()
            groups[key] = dist.new_subgroups_by_enumeration(lists)[0]
    return groups[key]


def flat_mesh(mesh: Mesh):
    """The 1-D ``DeviceMesh`` over every rank in row-major order: the mesh
    flattened (:data:`ALL`), as a graph's node and edge dimensions are."""
    _need_ranks(mesh)
    if "flat" not in mesh._cache:
        from torch.distributed.device_mesh import DeviceMesh

        mesh._cache["flat"] = DeviceMesh(mesh.device_mesh.device_type,
                                         torch.arange(mesh.size), mesh_dim_names=("flat",))
    return mesh._cache["flat"]


# --------------------------------------------------------------------------
# the flat carrier: a graph's node and edge rows split over every rank
#
# A tensor whose leading (node or edge) dimension is split over every rank
# is a DTensor ``Shard(0)`` on :func:`flat_mesh` ("flat"): its global shape
# is the logical array's, its local tensor this rank's rows. Node rows and
# the batch's rows split evenly, as JAX's ``_maybe`` splits a dimension the
# mesh divides (rank ``r`` holds rows ``[r·N/n, (r+1)·N/n)``, ``r``
# flattened row-major over ``(pod, data, model)``); the rows of a region's
# edge results are ``torch.chunk``'s, ``ceil(E/n)`` a rank — the JAX
# region's padded edge shards, ragged where the mesh does not divide ``E``.
# No DTensor of the port communicates (see ``dist.collectives``): the
# dense work on the rows runs on local tensors (:func:`rowwise`), the
# gathers are the collectives'.


def is_flat(x) -> bool:
    """Whether ``x`` is a flat DTensor (see above)."""
    from torch.distributed.tensor import DTensor, Shard

    return (isinstance(x, DTensor) and x.device_mesh.ndim == 1
            and tuple(x.placements) == (Shard(0),))


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a flat DTensor (its local tensor; the gradient
    flows back into the DTensor); any other tensor itself."""
    return x.to_local() if is_flat(x) else x


def row_start(x: torch.Tensor) -> int:
    """The global index of this rank's first row of a flat DTensor
    (``rank · ceil(rows / n)``); 0 for any other tensor."""
    if not is_flat(x):
        return 0
    dm = x.device_mesh
    return dm.get_local_rank() * -(-x.shape[0] // dm.size())


def _contiguous_strides(shape):
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


def from_rows(local: torch.Tensor, rows: int, dm) -> torch.Tensor:
    """This rank's ``local`` rows as the flat DTensor of ``rows`` global
    rows on ``dm`` (a :func:`flat_mesh`); no collective."""
    from torch.distributed.tensor import DTensor, Shard

    shape = (rows,) + tuple(local.shape[1:])
    return DTensor.from_local(local, dm, [Shard(0)], run_check=False, shape=shape,
                              stride=_contiguous_strides(shape))


def splits_rows(mesh: Optional[Mesh], rows: int) -> bool:
    """Whether ``rows`` rows split over every rank of ``mesh``: a mesh of
    several ranks on a process group whose size divides them (JAX's
    ``_maybe`` keeps :data:`ALL` on such a dimension)."""
    return (mesh is not None and mesh.size > 1 and mesh.device_mesh is not None
            and rows % mesh.size == 0)


def shard_rows(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` (whole on every rank) as this rank's block of its rows, a flat
    DTensor — a view, no collective; backward the ranks' cotangents of
    their blocks all-gathered (JAX's transpose of a replicated value
    constrained to row shards: the whole value's cotangent on every rank)
    — where ``mesh`` (by default the active one) splits them
    (:func:`splits_rows`); else ``x`` itself, as is a flat DTensor."""
    mesh = mesh or _ACTIVE_MESH
    if is_flat(x) or not splits_rows(mesh, x.shape[0]):
        return x
    dm = flat_mesh(mesh)
    return from_rows(collectives.own_block(x, 0, dm.get_group()), x.shape[0], dm)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A flat DTensor gathered whole on every rank (its rows ragged or
    not): a plain tensor; backward this rank's rows of the cotangent. Any
    other tensor itself."""
    if not is_flat(x):
        return x
    dm, rows = x.device_mesh, x.shape[0]
    per = -(-rows // dm.size())
    local = x.to_local()
    if local.shape[0] != per:
        local = torch.cat([local, local.new_zeros((per - local.shape[0],) + local.shape[1:])])
    return collectives.all_gather_rows(local, dm.get_group())[:rows]


def _map_tensors(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def rowwise(fn, rows: Sequence[torch.Tensor], params=None):
    """``fn(*rows)`` (``fn(*rows, params)`` when ``params`` is given) on
    this rank's rows. Where one of ``rows`` (tensors of one leading
    dimension: nodes, or edges) is a flat DTensor, ``fn`` takes each as
    its rank's rows — a plain one, whole on every rank, cut to its block
    as :func:`shard_rows` cuts it — and every tensor of ``params`` through
    ``collectives.copy_in`` (the ranks' gradients summed: each rank's rows
    hold its share of it); each tensor ``fn`` returns (one, or a tuple)
    becomes the flat DTensor of the same global rows. Otherwise ``fn`` on
    the tensors as they are, the one-rank computation itself."""
    rows = tuple(rows)
    extra = () if params is None else (params,)
    flat = next((t for t in rows if is_flat(t)), None)
    if flat is None:
        return fn(*rows, *extra)
    dm, n_rows = flat.device_mesh, flat.shape[0]
    group = dm.get_group()
    local = [t.to_local() if is_flat(t) else collectives.own_block(t, 0, group) for t in rows]
    extra = tuple(_map_tensors(lambda p: collectives.copy_in(p, group), e) for e in extra)
    out = fn(*local, *extra)
    if isinstance(out, tuple):
        return tuple(from_rows(o, n_rows, dm) for o in out)
    return from_rows(out, n_rows, dm)


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


def _check_order(sharding: NamedSharding) -> None:
    """A spec entry naming several axes names them in mesh order (the order
    in which :func:`_local_slices` and :func:`axis_group` flatten them)."""
    mesh = sharding.mesh
    for entry in sharding.spec:
        names = _names(entry)
        if list(names) != sorted(names, key=mesh.axis_names.index):
            raise NotImplementedError(f"spec entry {entry} is not in mesh order")


def shard_shape(shape: Sequence[int], sharding: NamedSharding) -> Tuple[int, ...]:
    """The shape of one rank's slice of a ``shape`` array: JAX's
    ``NamedSharding.shard_shape`` for the specs the rules make (every
    entry divides its dimension)."""
    return tuple(n // axis_size(sharding.spec[d] if d < len(sharding.spec) else None,
                                sharding.mesh) for d, n in enumerate(shape))


def shard_of(x: torch.Tensor, sharding: NamedSharding, coordinate=None) -> torch.Tensor:
    """The slice of the whole leaf ``x`` that the rank at ``coordinate``
    holds under ``sharding`` (a view; its index along each mesh axis). By
    default this process's place on the mesh; a mesh without a process
    group is one rank, which holds ``x`` whole."""
    _check_order(sharding)
    if coordinate is None:
        if sharding.mesh.device_mesh is None:
            return x
        coordinate = sharding.mesh.device_mesh.get_coordinate()
    return x[_local_slices(x.shape, sharding, coordinate)]


def sharded_dims(sharding: NamedSharding) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """``(dimension, axes)`` of every dimension that ``sharding`` splits
    over more than one rank (axes of size 1 left out)."""
    mesh = sharding.mesh
    out = []
    for d, entry in enumerate(sharding.spec):
        names = tuple(n for n in _names(entry) if mesh.shape[n] > 1)
        if names:
            out.append((d, names))
    return tuple(out)


def unshard(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """:func:`shard_of`'s inverse over the process group: this rank's slice
    gathered with every other rank's into the whole leaf (an all-gather
    over each split dimension's axes; no gradient). On one rank, ``local``."""
    if sharding.mesh.device_mesh is None:
        return local
    for d, axes in sharded_dims(sharding):
        local = collectives.all_gather_dim(local.detach(), d, axis_group(sharding.mesh, axes))
    return local


@dataclasses.dataclass(frozen=True)
class Gather:
    """How a leaf held as this rank's shard becomes the whole leaf where a
    model uses it: ``dims`` holds ``(dimension, process group, mean)`` for
    each split dimension, gathered by ``collectives.all_gather_dim``, whose
    backward gives the shard its gradient — reduce-scattered and averaged
    over the group where ``mean`` (the group's ranks split the batch, so
    each holds its share of the gradient), else this rank's slice (the
    group's ranks repeat the same work, so each holds the whole one).
    ``lead`` leading dimensions dropped: a layer's view of a stacked leaf."""

    dims: Tuple[Tuple[int, Any, bool], ...]

    def __call__(self, t: torch.Tensor, lead: int = 0) -> torch.Tensor:
        for d, group, mean in self.dims:
            t = collectives.all_gather_dim(t, d - lead, group, mean)
        return t

    @classmethod
    def of(cls, sharding: NamedSharding, batch_axes: Sequence[str] = (),
           keep: Sequence[str] = ()) -> "Gather":
        """The gather of a leaf under ``sharding``, the batch split over
        ``batch_axes`` (a dimension split over those axes only averages its
        gradient; any other takes its slice). A dimension split over an
        axis of ``keep`` stays split: the model uses its slice (the MoE's
        experts a rank)."""
        return cls(tuple((d, axis_group(sharding.mesh, axes),
                          bool(batch_axes) and set(axes) <= set(batch_axes))
                         for d, axes in sharded_dims(sharding) if not set(axes) & set(keep)))


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

    local = shard_of(x, sharding).contiguous().to(dev)
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
