"""Edge-balanced contiguous-range vertex partitioning (host-side).

The port of ``repro.graph.partition.partitioner``. The partitioner splits
the vertex id space ``[0, N)`` into ``S`` contiguous ranges by a greedy
prefix split on the degree CSR: walking vertices in id order, a range
boundary is cut whenever the cumulative edge-endpoint count crosses the
next multiple of ``total/S``. Contiguous ranges keep the owner map a tiny
``[S+1]`` boundary array (owner lookup is a searchsorted, not an ``[N]``
table) and make every per-shard edge block a *slice* of the globally
sorted COO — local ids stay sorted, so segment reductions keep their CSR
offsets.

Edge assignment follows ownership of the *segment* vertex so reductions
never cross shards:

* pull ordering (sorted by ``dst``): an edge lives with ``dst``'s owner;
* push ordering (sorted by ``src``): with ``src``'s owner.

The neighbor endpoint of each local edge is remapped to *halo-local*
addressing: owned vertices keep their local row id ``g - start``, foreign
vertices get ``v_max + position`` in the shard's sorted ghost list. The
ghost lists and the per-(owner, reader) exchange indices are static — built
once per graph — so a superstep's halo exchange is two precomputed gathers
around one ``all_to_all`` (see :mod:`repro_torch.graph.partition.halo`).

The layout is built once in numpy, as in the JAX package, and held as
torch tensors with its dtypes (int32 ids, float32 weights, bool masks),
every per-shard array with a leading ``[S]`` dimension. What the port
adds are each shard's CSR offsets of both orderings (``in_ptr_l`` over
``dst_l``, ``out_ptr_l`` over ``t_src_l``, ``int32[S, v_max + 1]``), which
the card's segment reduction reads; padding edges have a local id of
``v_max`` and so lie past the last segment. :meth:`PartitionedGraph.shard`
takes one shard's view (the ``[r]`` slice of every per-shard array) onto a
device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.graph import ops as gops


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Static exchange plan for one edge ordering's ghost vertices.

    ``ghost_ids[s]`` are the global ids shard ``s`` reads but does not own,
    sorted ascending (padding: ``n_vertices``). ``send_local[i, j]`` are
    owner-``i``-local row ids of the values shard ``j`` needs (padding:
    ``v_max`` — clipped reads, never consumed); ``recv_pos[j, i]`` are the
    slots in ``j``'s ghost buffer where values from owner ``i`` land
    (padding: ``n_ghost`` — a dump slot sliced off after scatter).
    """

    ghost_ids: torch.Tensor  # i32[S, H]
    send_local: torch.Tensor  # i32[S, S, Hp]  indexed [owner, reader, slot]
    recv_pos: torch.Tensor  # i32[S, S, Hp]  indexed [reader, owner, slot]
    n_ghost: int  # H
    pair_cap: int  # Hp


#: the per-shard arrays (leading ``[S]`` dimension) of each class
_SHARDED_PG_FIELDS = (
    "vmask", "src_g", "src_h", "dst_l", "w", "emask", "in_ptr_l",
    "t_dst_g", "t_dst_h", "t_src_l", "t_w", "t_emask", "out_ptr_l",
)
_SHARDED_HALO_FIELDS = ("ghost_ids", "send_local", "recv_pos")


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Per-shard graph blocks + owner maps + halo plans.

    All per-shard arrays carry a leading ``[S]`` dimension (``starts`` is
    the shared owner map); :meth:`shard` drops it for one shard. Vertex
    fields partition to ``[S, v_max]`` via :func:`partition_field`.
    """

    starts: torch.Tensor  # i32[S+1] contiguous range boundaries (owner map)
    vmask: torch.Tensor  # bool[S, v_max] valid local rows
    # pull ordering: edges assigned to dst's owner, sorted by local dst
    src_g: torch.Tensor  # i32[S, e_max] global src (value semantics)
    src_h: torch.Tensor  # i32[S, e_max] halo-local src (local row | v_max+pos)
    dst_l: torch.Tensor  # i32[S, e_max] local dst row (ascending; pad v_max)
    w: torch.Tensor  # f32[S, e_max]
    emask: torch.Tensor  # bool[S, e_max]
    in_ptr_l: torch.Tensor  # i32[S, v_max+1] segment offsets of dst_l
    # push ordering: edges assigned to src's owner, sorted by local src
    t_dst_g: torch.Tensor  # i32[S, e_max]
    t_dst_h: torch.Tensor  # i32[S, e_max]
    t_src_l: torch.Tensor  # i32[S, e_max]
    t_w: torch.Tensor  # f32[S, e_max]
    t_emask: torch.Tensor  # bool[S, e_max]
    out_ptr_l: torch.Tensor  # i32[S, v_max+1] segment offsets of t_src_l
    halo_in: HaloSpec  # ghosts read by the pull ordering (srcs)
    halo_out: HaloSpec  # ghosts read by the push ordering (dsts)
    n_vertices: int
    n_edges: int
    n_shards: int
    v_max: int
    e_max: int

    @property
    def sentinel(self) -> int:
        return self.n_vertices

    @property
    def device(self) -> torch.device:
        return self.vmask.device

    def _map(self, fn, pg_fields, halo_fields) -> "PartitionedGraph":
        def halo(spec):
            return dataclasses.replace(
                spec, **{f: fn(getattr(spec, f)) for f in halo_fields}
            )

        return dataclasses.replace(
            self,
            halo_in=halo(self.halo_in),
            halo_out=halo(self.halo_out),
            **{f: fn(getattr(self, f)) for f in pg_fields},
        )

    def to(self, device) -> "PartitionedGraph":
        """The same partition with every tensor on ``device``."""
        return self._map(
            lambda t: t.to(device),
            ("starts",) + _SHARDED_PG_FIELDS,
            _SHARDED_HALO_FIELDS,
        )

    def shard(self, rank: int, device=None) -> "PartitionedGraph":
        """Shard ``rank``'s view: the ``[rank]`` slice of every per-shard
        array (``starts`` stays whole), on ``device`` (default: where the
        partition is). The counterpart of one JAX ``shard_map`` block."""
        device = self.device if device is None else device
        view = self._map(
            lambda t: t[rank].to(device), _SHARDED_PG_FIELDS, _SHARDED_HALO_FIELDS
        )
        return dataclasses.replace(view, starts=self.starts.to(device))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def edge_balanced_ranges(graph, n_shards: int) -> np.ndarray:
    """Greedy prefix split on the degree CSR → boundaries ``i64[S+1]``.

    Balances the per-shard *assigned edge* count: each vertex weighs its
    in-degree (pull edges it owns) + out-degree (push edges) + 1 (so
    isolated vertices still spread). The greedy cut guarantees every
    shard's weight ≤ ``total/S + max_vertex_weight`` (the classic prefix
    bound), and each shard owns at least one vertex.
    """
    n = graph.n_vertices
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if n < n_shards:
        raise ValueError(
            f"cannot give each of {n_shards} shards a vertex: only {n} exist"
        )
    dst = _host(graph.dst)[_host(graph.edge_mask)]
    t_src = _host(graph.t_src)[_host(graph.t_mask)]
    # the counts of np.add.at, in one pass each
    weight = 1 + np.bincount(dst, minlength=n) + np.bincount(t_src, minlength=n)
    cum = np.cumsum(weight.astype(np.int64))
    total = int(cum[-1])
    bounds = np.zeros(n_shards + 1, dtype=np.int64)
    bounds[n_shards] = n
    for k in range(1, n_shards):
        target = total * k / n_shards
        cut = int(np.searchsorted(cum, target, side="left")) + 1
        # keep ≥1 vertex per shard on both sides of the cut
        cut = max(cut, int(bounds[k - 1]) + 1)
        cut = min(cut, n - (n_shards - k))
        bounds[k] = cut
    return bounds


def _build_halo(
    nbr_global: np.ndarray,  # [S, e_max] global neighbor ids (pad: N)
    emask: np.ndarray,  # [S, e_max]
    bounds: np.ndarray,  # [S+1]
    n: int,
    v_max: int,
):
    """Ghost lists + exchange plan + halo-local remap for one ordering.

    Returns ``(halo_spec_arrays, nbr_halo)`` where ``nbr_halo[s, e]`` is the
    halo-local address of ``nbr_global[s, e]`` on shard ``s``.
    """
    S = len(bounds) - 1
    ghosts, nbr_halo = [], np.full(nbr_global.shape, 0, dtype=np.int32)
    for s in range(S):
        m = emask[s]
        g = nbr_global[s][m]
        # the ghosts are the sorted distinct foreign ids (the JAX package's
        # unique-then-drop-owned, found here by a presence map over the
        # ids); a foreign id's address is v_max + its rank among them,
        # owned ids keep their local row
        foreign = (g < bounds[s]) | (g >= bounds[s + 1])
        gf = g[foreign]
        present = np.zeros(n, dtype=bool)
        present[gf] = True
        ghosts.append(np.flatnonzero(present))
        loc = (g - bounds[s]).astype(np.int64)
        loc[foreign] = v_max - 1 + np.cumsum(present)[gf]
        nbr_halo[s, m] = loc.astype(np.int32)
    H = max((len(g) for g in ghosts), default=0)
    ghost_ids = np.full((S, H), n, dtype=np.int32)
    for s, g in enumerate(ghosts):
        ghost_ids[s, : len(g)] = g

    # per-(owner, reader) slices of each reader's sorted ghost list
    pair_count = np.zeros((S, S), dtype=np.int64)
    pair_lo = np.zeros((S, S), dtype=np.int64)
    for j in range(S):
        lo = np.searchsorted(ghosts[j], bounds[:-1], side="left")
        hi = np.searchsorted(ghosts[j], bounds[1:], side="left")
        pair_lo[:, j] = lo
        pair_count[:, j] = hi - lo
    Hp = int(pair_count.max(initial=0))
    send_local = np.full((S, S, Hp), v_max, dtype=np.int32)
    recv_pos = np.full((S, S, Hp), H, dtype=np.int32)
    for i in range(S):
        for j in range(S):
            c = int(pair_count[i, j])
            if c == 0:
                continue
            lo = int(pair_lo[i, j])
            ids = ghosts[j][lo : lo + c]
            send_local[i, j, :c] = ids - bounds[i]
            recv_pos[j, i, :c] = np.arange(lo, lo + c)

    nbr_halo[~emask] = v_max + H  # padding edges: past the ghost buffer
    return (ghost_ids, send_local, recv_pos, H, Hp), nbr_halo


def _shard_edges(key, other, w, mask, bounds, v_max):
    """Slice one globally key-sorted COO into per-shard blocks.

    Returns (key_local [S,e_max], other_global [S,e_max], w, mask) with the
    padding conventions of :class:`PartitionedGraph`.
    """
    S = len(bounds) - 1
    mask = _host(mask)
    key = _host(key)[mask]
    other = _host(other)[mask]
    w = _host(w)[mask]
    lo = np.searchsorted(key, bounds[:-1], side="left")
    hi = np.searchsorted(key, bounds[1:], side="left")
    counts = hi - lo
    e_max = int(counts.max(initial=0))
    n = int(bounds[-1])
    key_l = np.full((S, e_max), v_max, dtype=np.int32)
    oth_g = np.full((S, e_max), n, dtype=np.int32)
    w_p = np.zeros((S, e_max), dtype=np.float32)
    m_p = np.zeros((S, e_max), dtype=bool)
    for s in range(S):
        c = int(counts[s])
        key_l[s, :c] = key[lo[s] : hi[s]] - bounds[s]
        oth_g[s, :c] = other[lo[s] : hi[s]]
        w_p[s, :c] = w[lo[s] : hi[s]]
        m_p[s, :c] = True
    return key_l, oth_g, w_p, m_p, e_max


def _segment_offsets(key_l: np.ndarray, v_max: int) -> np.ndarray:
    """Each shard's CSR offsets ``i32[S, v_max + 1]`` of its ascending
    local ids (padding ``v_max`` falls past the last segment)."""
    bounds = np.arange(v_max + 1)
    return np.stack(
        [np.searchsorted(row, bounds, side="left") for row in key_l]
    ).astype(np.int32)


def partition_graph(
    graph, n_shards: int, bounds: Optional[np.ndarray] = None
) -> PartitionedGraph:
    """Partition a dense :class:`~repro_torch.graph.structure.Graph` into
    ``S`` edge-balanced contiguous-range shards with static halo plans.
    The result lives on the host; :meth:`PartitionedGraph.to` and
    :meth:`PartitionedGraph.shard` move it."""
    n = graph.n_vertices
    if bounds is None:
        bounds = edge_balanced_ranges(graph, n_shards)
    bounds = np.asarray(bounds, dtype=np.int64)
    if len(bounds) != n_shards + 1 or bounds[0] != 0 or bounds[-1] != n:
        raise ValueError("bounds must be [0, ..., n_vertices] of length S+1")
    v_max = int(np.max(bounds[1:] - bounds[:-1]))

    dst_l, src_g, w_p, m_p, e_pull = _shard_edges(
        graph.dst, graph.src, graph.weight, graph.edge_mask, bounds, v_max
    )
    tsrc_l, tdst_g, tw_p, tm_p, e_push = _shard_edges(
        graph.t_src, graph.t_dst, graph.t_weight, graph.t_mask, bounds, v_max
    )
    e_max = max(e_pull, e_push, 1)

    def repad(key_l, oth_g, w, m):
        S, e = key_l.shape
        if e == e_max:
            return key_l, oth_g, w, m
        pad = e_max - e
        return (
            np.pad(key_l, ((0, 0), (0, pad)), constant_values=v_max),
            np.pad(oth_g, ((0, 0), (0, pad)), constant_values=n),
            np.pad(w, ((0, 0), (0, pad))),
            np.pad(m, ((0, 0), (0, pad))),
        )

    dst_l, src_g, w_p, m_p = repad(dst_l, src_g, w_p, m_p)
    tsrc_l, tdst_g, tw_p, tm_p = repad(tsrc_l, tdst_g, tw_p, tm_p)

    def halo_spec(gi, sl, rp, H, Hp):
        return HaloSpec(
            ghost_ids=torch.from_numpy(gi), send_local=torch.from_numpy(sl),
            recv_pos=torch.from_numpy(rp), n_ghost=H, pair_cap=Hp,
        )

    spec_in, src_h = _build_halo(src_g, m_p, bounds, n, v_max)
    spec_out, tdst_h = _build_halo(tdst_g, tm_p, bounds, n, v_max)

    sizes = (bounds[1:] - bounds[:-1])[:, None]
    vmask = np.arange(v_max)[None, :] < sizes
    t = torch.from_numpy
    return PartitionedGraph(
        starts=t(bounds.astype(np.int32)),
        vmask=t(vmask),
        src_g=t(src_g),
        src_h=t(src_h),
        dst_l=t(dst_l),
        w=t(w_p),
        emask=t(m_p),
        in_ptr_l=t(_segment_offsets(dst_l, v_max)),
        t_dst_g=t(tdst_g),
        t_dst_h=t(tdst_h),
        t_src_l=t(tsrc_l),
        t_w=t(tw_p),
        t_emask=t(tm_p),
        out_ptr_l=t(_segment_offsets(tsrc_l, v_max)),
        halo_in=halo_spec(*spec_in),
        halo_out=halo_spec(*spec_out),
        n_vertices=n,
        n_edges=int(_host(graph.edge_mask).sum()),
        n_shards=n_shards,
        v_max=v_max,
        e_max=e_max,
    )


# ---------------------------------------------------------------------------
# field (de)partitioning — layout shuffles on the field's device


def partition_field(pg: PartitionedGraph, x: torch.Tensor) -> torch.Tensor:
    """``[N, ...]`` dense vertex field → ``[S, v_max, ...]`` shard blocks
    (padding rows zero-filled; they are masked inactive by the executor)."""
    starts = pg.starts.to(x.device)
    idx = starts[:-1, None] + torch.arange(
        pg.v_max, dtype=torch.int32, device=x.device
    )[None, :]
    valid = idx < starts[1:, None]
    gathered = gops.gather(x, torch.clamp(idx, max=pg.n_vertices - 1))
    vshape = valid.shape + (1,) * (gathered.ndim - 2)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(valid.reshape(vshape), gathered, zero)


def unpartition_field(pg: PartitionedGraph, y: torch.Tensor) -> torch.Tensor:
    """``[S, v_max, ...]`` shard blocks → ``[N, ...]`` dense vertex field."""
    starts = pg.starts.to(y.device)
    g = torch.arange(pg.n_vertices, dtype=torch.int32, device=y.device)
    owner = torch.searchsorted(starts, g, right=True, out_int32=True) - 1
    flat_pos = owner * pg.v_max + (g - gops.gather(starts, owner))
    flat = y.reshape((pg.n_shards * pg.v_max,) + y.shape[2:])
    return gops.gather(flat, flat_pos)


def partition_fields(pg: PartitionedGraph, fields: Dict) -> Dict:
    return {k: partition_field(pg, v) for k, v in fields.items()}


def unpartition_fields(pg: PartitionedGraph, fields: Dict) -> Dict:
    return {k: unpartition_field(pg, v) for k, v in fields.items()}
