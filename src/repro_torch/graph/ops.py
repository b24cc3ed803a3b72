"""Segment/gather/scatter primitives — the message-passing substrate.

The non-mesh half of ``repro.graph.ops`` with its combiner semantics, on
torch tensors. The two hot primitives go through hand-written kernels on
the card: :func:`gather` (the remote read) calls
``kernels.gather_rows`` and :func:`segment_reduce` (the message combiner)
calls ``kernels.segment_reduce``; on CPU and meta tensors those wrappers
take their plain PyTorch versions. :func:`scatter_combine` has no kernel
in the JAX package either and stays on ``scatter_reduce_``.

Index rules follow the JAX functions exactly, and they differ per op:

* :func:`gather` without ``fill`` clips (``jnp.take(mode="clip")``: −1
  reads row 0); with ``fill`` an index in ``[-n, -1]`` wraps and any other
  out-of-range index reads ``fill`` (``jnp.take(mode="fill")``);
* :func:`scatter_combine` wraps ``[-n, -1]`` and drops the rest
  (``.at[idx].op(mode="drop")``);
* :func:`segment_reduce` drops every id outside ``[0, num_segments)``
  (``jax.ops.segment_*``), the padding sentinel included;
* :func:`edge_softmax` reads its per-segment values as ``x[ids]`` does:
  ``[-n, -1]`` wraps, then every id is clamped.

A float written into an int32 buffer converts as XLA's does (:func:`to_int32`).

Both go through ``kernels.autograd``, so they carry gradients: the
gather's to its field, the reduction's (sum, max, min) to its values,
each backward on the same kernels; :func:`edge_softmax` differentiates
through both, its segment max included, as JAX's does (no stop-gradient).
The int and bool paths (``to_int32``, or/and) carry none.

The message-passing wrappers of the GNN layers (:func:`mp_gather`,
:func:`mp_segment_reduce`, :func:`mp_edge_softmax`) are the JAX functions:
without a multi-rank mesh the plain :func:`gather`, :func:`segment_reduce`
and :func:`edge_softmax`, with the segment ``offsets`` passed through (the
card needs them); on one, the ``shard_map`` branch (each rank's edge
rows against the node state gathered whole at the region's entry, on the
same kernels, then one collective of ``dist.collectives``; node and edge
tensors split over the ranks are flat DTensors; see the section below).

Dtypes stay the JAX package's (x64 off): int32 ids, float32, bool.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.graph.structure import segment_offsets
from repro_torch.kernels import autograd as kernel_grad
from repro_torch.kernels import fake
from repro_torch.kernels.segment_reduce import ops as segment_kernel

# identity element per combiner, keyed by op name
COMBINE_IDENTITY = {
    "sum": 0.0,
    "min": math.inf,
    "max": -math.inf,
    "prod": 1.0,
    "and": True,
    "or": False,
}


#: the combiner identity in a dtype, as a Python scalar (it joins a
#: ``torch.where`` without a host-to-device copy)
_identity_for = segment_kernel.identity


#: elementwise combiner application — the single source for every site that
#: folds two already-reduced values; keep in sync with COMBINE_IDENTITY
COMBINE_FN = {
    "sum": torch.add,
    "prod": torch.mul,
    "min": torch.minimum,
    "max": torch.maximum,
    "or": torch.logical_or,
    "and": torch.logical_and,
}


def combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a op b`` for a Palgol combiner."""
    if op not in COMBINE_FN:
        raise ValueError(f"unknown combiner {op!r}")
    return COMBINE_FN[op](a, b)


def combine_along_axis(op: str, arr: torch.Tensor, axis: int) -> torch.Tensor:
    """Reduce one array axis with a Palgol combiner (sums of int32 stay
    int32 and sums of bool become int32, as in JAX)."""
    if op in ("sum", "prod"):
        dtype = torch.int32 if arr.dtype == torch.bool else arr.dtype
        fn = torch.sum if op == "sum" else torch.prod
        return fn(arr, dim=axis, dtype=dtype)
    reducers = {
        "min": torch.amin,
        "max": torch.amax,
        "or": torch.any,
        "and": torch.all,
    }
    if op not in reducers:
        raise ValueError(f"unknown combiner {op!r}")
    return reducers[op](arr, dim=axis)


def segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str = "sum",
    indices_are_sorted: bool = False,
    mask: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reduce ``values`` by ``segment_ids`` with combiner ``op``.

    Unreduced segments receive the combiner identity (matching Palgol's list
    comprehension over an empty neighbor list, e.g. ``minimum [] = inf``).
    ``offsets`` are the segment offsets of sorted ids (a graph's
    ``in_ptr``/``out_ptr``); the card needs them, and computes them from
    the ids only when the caller declares the ids sorted — unsorted ids
    on the card raise.
    """
    if op not in segment_kernel.OPS:
        raise ValueError(f"unknown combiner {op!r}")
    if op in ("or", "and") and values.dtype != torch.bool:
        # through int32 max/min, clamped, as the JAX package computes them
        if mask is not None:
            mshape = mask.shape + (1,) * (values.ndim - mask.ndim)
            values = torch.where(
                mask.reshape(mshape), values, _identity_for(op, values.dtype)
            )
        asint = segment_reduce(
            to_int32(values), segment_ids, num_segments,
            "max" if op == "or" else "min", indices_are_sorted, offsets=offsets,
        )
        if op == "or":
            return asint.clamp(min=0).to(torch.bool)
        return asint.clamp(max=1).to(torch.bool)
    if fake.on_card(values) and offsets is None:
        if not indices_are_sorted:
            raise ValueError(
                "segment_reduce on the card needs sorted segment ids "
                "(indices_are_sorted=True) or their offsets"
            )
        offsets = segment_offsets(segment_ids.to(torch.int32), num_segments)
    return kernel_grad.segment_reduce(
        values.contiguous(), segment_ids, num_segments, op,
        mask=None if mask is None else mask.contiguous(), offsets=offsets,
    )


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int32)`` with XLA's conversion: floats truncate toward
    zero, saturate at the int32 range, and NaN becomes 0."""
    if not x.is_floating_point():
        return x.to(torch.int32)
    lo, hi = -(2.0**31), 2.0**31
    bad = torch.isnan(x) | (x >= hi) | (x < lo)
    out = torch.where(bad, 0, x).to(torch.int32)
    out = torch.where(x >= hi, torch.iinfo(torch.int32).max, out)
    return torch.where(x < lo, torch.iinfo(torch.int32).min, out)


def gather(field: torch.Tensor, idx, fill=None) -> torch.Tensor:
    """``field[idx]`` with out-of-range indices reading a fill value.

    This is the dense-runtime realization of a Palgol remote *read*. The
    padding sentinel (== n_vertices) reads ``fill``; without ``fill`` every
    index is clipped into range.
    """
    if not isinstance(idx, torch.Tensor):
        idx = torch.tensor(idx, dtype=torch.int32)
    idx = to_int32(idx).to(field.device)
    flat = kernel_grad.gather_rows(
        field.contiguous(), idx.reshape(-1).contiguous(), fill
    )
    return flat.reshape(idx.shape + field.shape[1:])


def _drop_index(idx: torch.Tensor, n: int, mask=None) -> torch.Tensor:
    """int64 scatter rows under ``mode="drop"``: ``[-n, -1]`` wraps, every
    other out-of-range (or masked) index goes to the sentinel row ``n``."""
    idx = idx.long()
    if mask is not None:
        idx = torch.where(mask, idx, n)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _scatter(buffer, idx, values, reduce: Optional[str], mask=None):
    """``buffer.at[idx].<reduce>(values, mode="drop")`` out of place, via an
    extra sentinel row that takes the dropped writes. As in JAX, the scatter
    runs in the promoted type of ``buffer`` and ``values``, and the result
    converts back to the buffer's dtype as XLA converts (f32 values into an
    int32 buffer: summed in f32, then saturated, NaN as 0)."""
    n = buffer.shape[0]
    rows = _drop_index(idx, n, mask)
    dtype = torch.promote_types(buffer.dtype, values.dtype)
    ext = torch.cat([buffer, buffer.new_zeros((1,) + buffer.shape[1:])]).to(dtype)
    values = values.to(dtype).expand(rows.shape + buffer.shape[1:])
    index = rows.reshape(rows.shape + (1,) * (buffer.ndim - 1)).expand(values.shape)
    if reduce is None:
        ext.scatter_(0, index, values)
    else:
        ext.scatter_reduce_(0, index, values, reduce, include_self=True)
    out = ext[:n]
    return to_int32(out) if buffer.dtype == torch.int32 else out.to(buffer.dtype)


def scatter_set(buffer: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``buffer.at[idx].set(values, mode="drop")``; which of several writes
    to one row lands is unspecified, as in JAX."""
    return _scatter(buffer, idx, torch.as_tensor(values, device=buffer.device), None)


def scatter_combine(
    buffer: torch.Tensor,
    idx: torch.Tensor,
    values: torch.Tensor,
    op: str = "sum",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply accumulative remote writes: ``buffer[idx] op= values``.

    Out-of-range indices are dropped and ``[-n, -1]`` wraps (the JAX
    ``mode="drop"`` scatter), which both implements Pregel's "message to
    nobody" for padding rows and makes halted-vertex masking cheap.
    """
    reduce = {"sum": "sum", "prod": "prod", "min": "amin", "max": "amax"}
    if op in reduce:
        return _scatter(buffer, idx, values, reduce[op], mask)
    if op in ("or", "and"):
        out = _scatter(
            to_int32(buffer), idx, to_int32(values),
            "amax" if op == "or" else "amin", mask,
        )
        return out.to(buffer.dtype)
    raise ValueError(f"unknown combiner {op!r}")


def edge_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    indices_are_sorted: bool = False,
    offsets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically-stable softmax over edges grouped by destination (GAT)."""
    if mask is not None:
        mshape = mask.shape + (1,) * (scores.ndim - mask.ndim)
        scores = torch.where(mask.reshape(mshape), scores, -math.inf)
    seg_max = segment_reduce(
        scores, segment_ids, num_segments, "max", indices_are_sorted,
        offsets=offsets,
    )
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    # x[ids] as JAX reads it: [-n, -1] wraps, then gather clamps every id
    ids = torch.where(segment_ids < 0, segment_ids + num_segments, segment_ids)
    ex = torch.exp(scores - gather(seg_max, ids))
    if mask is not None:
        ex = torch.where(mask.reshape(mshape), ex, 0.0)
    denom = segment_reduce(
        ex, segment_ids, num_segments, "sum", indices_are_sorted, offsets=offsets
    )
    return ex / torch.clamp(gather(denom, ids), min=1e-16)


# ---------------------------------------------------------------------------
# mesh-aware message passing: under an active multi-rank mesh these run the
# gather/scatter *locally* per edge shard, with the node state gathered
# whole at the region's entry, and reduce partials with one collective (the
# JAX package's ``shard_map`` branch; vertex-cut partitioning):
#
#   mp_gather          node[N,D] (gathered whole) × idx[E](sharded) → edge-local
#   mp_segment_reduce  edge-local values → local partial [N,D] → psum/pmax
#
# A rank is one process; its region works on plain tensors and ends in one
# collective of ``dist.collectives``, whose backward is the transpose JAX
# takes. A node or edge tensor split over the ranks is a flat DTensor
# (``dist.sharding``'s carrier: its local tensor holds this rank's rows) —
# a batch's edge leaves where the mesh divides E, node state between
# layers, a region's edge results; one whole on every rank is a plain
# tensor, as is a replicated result.


def _mp_mesh():
    """(mesh, daxes, n_data): the active mesh, its axes flattened for the
    edge dimension (pod, data, model — every axis: edges are the only large
    dimension) and their size product."""
    from repro_torch.dist import sharding as shd

    mesh = shd.active_mesh()
    if mesh is None:
        return None, (), 1
    daxes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    return mesh, daxes, math.prod(mesh.shape[a] for a in daxes)


def _pad_rows(x: torch.Tensor, n_rows: int, fill) -> torch.Tensor:
    """Pad the leading dim up to ``n_rows`` with a constant."""
    pad = n_rows - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


class EdgeRegion:
    """This rank's share of an edge dimension of ``e`` rows over the ``n``
    ranks of ``daxes``: the rows ``[r·E_pad/n, (r+1)·E_pad/n)`` of the edges
    padded to ``E_pad = ceil(E/n)·n``, ``r`` the rank's index flattened
    row-major over ``daxes``; ``real`` of them are edges, the rest padding."""

    def __init__(self, mesh, daxes, n: int, e: int):
        from repro_torch.dist import sharding as shd

        self.mesh, self.n, self.e = mesh, n, e
        self.group = shd.axis_group(mesh, daxes)
        self.rank = torch.distributed.get_rank(self.group)
        self.e_loc = -(-e // n)
        self.start = self.rank * self.e_loc
        self.real = max(0, min(self.e_loc, e - self.start))

    def rows(self, t: torch.Tensor, fill) -> torch.Tensor:
        """This rank's rows of an ``[E, ...]`` edge tensor, padded with
        ``fill``: a flat DTensor's local rows, or the rows cut from a tensor
        whole on every rank."""
        from repro_torch.dist import sharding as shd

        if shd.is_flat(t):
            return _pad_rows(t.to_local(), self.e_loc, fill)
        return _pad_rows(t[self.start:self.start + self.real], self.e_loc, fill)

    def values(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of edge values, padded with 0; a tensor whole on
        every rank enters the region (its gradient sums over the ranks)."""
        from repro_torch.dist import collectives as coll
        from repro_torch.dist import sharding as shd

        return self.rows(t if shd.is_flat(t) else coll.copy_in(t, self.group), 0)

    def nodes(self, field: torch.Tensor) -> torch.Tensor:
        """Node state whole on every rank at the region's entry (JAX's
        ``in_specs`` ``P(None)``): a flat DTensor's rows all-gathered, its
        backward the ranks' partial cotangents summed in float32 and
        reduce-scattered onto their rows (JAX's all-gather, then the
        region's psum of its unmapped input, then a slice); a tensor whole
        on every rank enters through ``copy_in``."""
        from repro_torch.dist import collectives as coll
        from repro_torch.dist import sharding as shd

        if shd.is_flat(field):
            return coll.all_gather_sum(field.to_local(), 0, self.group)
        return coll.copy_in(field, self.group)

    def offsets(self, offsets: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The segment offsets of this rank's rows of sorted ids (the padding
        lies past the last one), from offsets into the global rows: the whole
        ids' or those of this rank's own rows (``models.gnn.models.
        dst_offsets``), which agree on them."""
        if offsets is None:
            return None
        return torch.clamp(offsets - self.start, 0, self.real).to(torch.int32)

    def shard(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's ``e_loc`` result rows as the flat DTensor of the
        global ``[E, ...]`` result (the padding rows cut off)."""
        from repro_torch.dist import sharding as shd

        return shd.from_rows(local[:self.real], self.e, shd.flat_mesh(self.mesh))


def _region(n_edges: int):
    """The :class:`EdgeRegion` of the active mesh, or ``None`` off-mesh."""
    mesh, daxes, n_data = _mp_mesh()
    if mesh is None or n_data == 1:
        return None
    return EdgeRegion(mesh, daxes, n_data, n_edges)


def edge_sharded(t: torch.Tensor) -> torch.Tensor:
    """An ``[E, ...]`` tensor as the flat DTensor of a region's edge rows on
    the active multi-rank mesh (unchanged off-mesh or if already one)."""
    from repro_torch.dist import sharding as shd

    if shd.is_flat(t):
        return t
    region = _region(t.shape[0])
    return t if region is None else region.shard(region.values(t))


def mp_gather(field: torch.Tensor, idx, fill=None) -> torch.Tensor:
    """Edge-sharded gather of node state.

    Off-mesh, :func:`gather`. On a multi-rank mesh each rank gathers its
    rows of ``idx`` (padded with 0 to mesh divisibility, the padding sliced
    off again) from the whole ``field`` (gathered at entry when its rows
    are split: :meth:`EdgeRegion.nodes`) and returns its rows of the
    ``[E, ...]`` result as a flat DTensor."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.tensor(idx, dtype=torch.int32)
    region = _region(idx.shape[0])
    if region is None:
        return gather(field, idx, fill)
    return region.shard(gather(region.nodes(field), region.rows(idx, 0), fill))


def mp_segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str = "sum",
    mask: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Edge-sharded segment reduction → replicated node result.

    Off-mesh, :func:`segment_reduce` (sentinel ids ``== num_segments`` are
    dropped). On a multi-rank mesh each rank reduces its rows (padded to
    mesh divisibility with id ``num_segments`` and mask False) into a local
    partial ``[N, ...]``, then one collective: psum for sum and prod (the
    JAX package's, so a prod is the sum of the ranks' partial products),
    ``_diff_pminmax`` for max and min, int32 pmax/pmin then bool for or
    and and. ``offsets`` index the global rows (:meth:`EdgeRegion.offsets`)."""
    region = _region(segment_ids.shape[0])
    if region is None:
        return segment_reduce(values, segment_ids, num_segments, op, mask=mask,
                              offsets=offsets)
    from repro_torch.dist import collectives as coll

    if mask is None:
        mask = torch.ones(segment_ids.shape[:1], dtype=torch.bool, device=segment_ids.device)
    part = segment_reduce(
        region.values(values), region.rows(segment_ids, num_segments), num_segments, op,
        mask=region.rows(mask, False), offsets=region.offsets(offsets),
    )
    if op in ("sum", "prod"):
        return coll.psum(part, region.group)
    if op in ("max", "min"):
        # the output is replicated over every rank: JAX hands each its
        # cotangent divided by their number
        return coll.pminmax(part, region.group, op == "max", 1.0 / region.n)
    if op in ("or", "and"):
        return coll.pmax_int(part, region.group, op == "or").to(torch.bool)
    raise ValueError(op)


def mp_edge_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax over edges grouped by destination. Off-mesh,
    :func:`edge_softmax`; on a multi-rank mesh composed from the mesh-aware
    primitives, as the JAX package composes it (its gathers clip)."""
    if _region(segment_ids.shape[0]) is None:
        return edge_softmax(scores, segment_ids, num_segments, mask=mask,
                            offsets=offsets)
    scores = edge_sharded(scores)
    seg_max = mp_segment_reduce(scores, segment_ids, num_segments, "max", mask=mask,
                                offsets=offsets)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(scores - mp_gather(seg_max, segment_ids))
    if mask is not None:
        mshape = mask.shape + (1,) * (scores.ndim - mask.ndim)
        ex = torch.where(edge_sharded(mask.reshape(mshape)), ex, 0.0)
    denom = mp_segment_reduce(ex, segment_ids, num_segments, "sum", offsets=offsets)
    return ex / torch.clamp(mp_gather(denom, segment_ids), min=1e-16)


def in_degrees(graph) -> torch.Tensor:
    ones = graph.edge_mask.to(torch.int32)
    return segment_reduce(
        ones, graph.dst, graph.n_vertices, "sum", indices_are_sorted=True,
        offsets=graph.in_ptr,
    )


def out_degrees(graph) -> torch.Tensor:
    ones = graph.t_mask.to(torch.int32)
    return segment_reduce(
        ones, graph.t_src, graph.n_vertices, "sum", indices_are_sorted=True,
        offsets=graph.out_ptr,
    )
