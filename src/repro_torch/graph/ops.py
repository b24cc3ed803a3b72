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
  (``jax.ops.segment_*``), the padding sentinel included.

Dtypes stay the JAX package's (x64 off): int32 ids, float32, bool.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.graph.structure import segment_offsets
from repro_torch.kernels.gather_rows import ops as gather_kernel
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
    if values.device.type == "cuda" and offsets is None:
        if not indices_are_sorted:
            raise ValueError(
                "segment_reduce on the card needs sorted segment ids "
                "(indices_are_sorted=True) or their offsets"
            )
        offsets = segment_offsets(segment_ids.to(torch.int32), num_segments)
    return segment_kernel.segment_reduce(
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
    flat = gather_kernel.gather_rows(
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
    extra sentinel row that takes the dropped writes."""
    n = buffer.shape[0]
    rows = _drop_index(idx, n, mask)
    ext = torch.cat([buffer, buffer.new_zeros((1,) + buffer.shape[1:])])
    values = values.to(buffer.dtype).expand(rows.shape + buffer.shape[1:])
    index = rows.reshape(rows.shape + (1,) * (buffer.ndim - 1)).expand(values.shape)
    if reduce is None:
        ext.scatter_(0, index, values)
    else:
        ext.scatter_reduce_(0, index, values, reduce, include_self=True)
    return ext[:n]


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
            buffer.to(torch.int32), idx, to_int32(values),
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
    ex = torch.exp(scores - gather(seg_max, segment_ids))
    if mask is not None:
        ex = torch.where(mask.reshape(mshape), ex, 0.0)
    denom = segment_reduce(
        ex, segment_ids, num_segments, "sum", indices_are_sorted, offsets=offsets
    )
    return ex / torch.clamp(gather(denom, segment_ids), min=1e-16)


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
