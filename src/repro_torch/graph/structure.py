"""Dense, statically-shaped graph representation on torch tensors.

The layout is the JAX package's (``repro.graph.structure``): a
struct-of-arrays sorted-COO edge list (``src``, ``dst``, ``weight``) padded
to a fixed edge count, plus an explicit validity mask. Edges are sorted by
``dst`` so that "receive messages along incoming edges" is a sorted
segment reduction; the transpose ordering (``t_*``, sorted by ``src``)
serves traversal of ``Out[v]``.

What the port adds are the **segment offsets** of each ordering: CSR row
pointers ``in_ptr``/``out_ptr`` of length ``n_vertices + 1`` (segment ``v``
of the ``dst`` ordering is rows ``in_ptr[v]:in_ptr[v+1]``). They depend on
the graph structure only, so they are computed once here and handed to
every segment reduction, which then never has to search the ids.

Conventions
-----------
* An edge ``(src[i], dst[i])`` means: ``dst[i]`` can *pull* data from
  ``src[i]``. For Palgol's ``In[v]`` the neighbor id ``e.id`` is ``src``;
  for ``Out[v]`` the transposed arrays are used; for undirected ``Nbr[v]``
  the edge list must be symmetric (see :func:`symmetrize`).
* Padding edges carry ``src = dst = n_vertices`` (an out-of-range
  sentinel) and ``mask = False``. The offsets stop at ``n_vertices``, so
  sentinel rows lie past the last segment and are never reduced.
* Dtypes are the JAX package's with x64 off: ids int32, weights float32,
  masks bool.

Graphs are built on ``device="cuda"`` unless the caller names another
device; without a card that raises instead of silently using the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

#: the edge arrays a :class:`Graph` carries, in the JAX ``Graph``'s order
EDGE_ARRAYS = (
    "src", "dst", "weight", "edge_mask", "t_src", "t_dst", "t_weight", "t_mask",
)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class Graph:
    """Static-shape graph. ``n_vertices``/``n_edges`` are Python ints."""

    src: torch.Tensor  # i32[E]  edge source, sorted by dst
    dst: torch.Tensor  # i32[E]  edge destination (ascending)
    weight: torch.Tensor  # f32[E] edge weight (1.0 if unweighted)
    edge_mask: torch.Tensor  # bool[E] False on padding rows
    t_src: torch.Tensor  # i32[E]  transpose ordering, sorted by src
    t_dst: torch.Tensor  # i32[E]
    t_weight: torch.Tensor  # f32[E]
    t_mask: torch.Tensor  # bool[E]
    in_ptr: torch.Tensor  # i32[n+1] segment offsets of the dst ordering
    out_ptr: torch.Tensor  # i32[n+1] segment offsets of the src ordering
    n_vertices: int
    n_edges: int

    @property
    def sentinel(self) -> int:
        return self.n_vertices

    @property
    def device(self) -> torch.device:
        return self.src.device

    def in_edges(self):
        """(neighbor_id, self_id, weight, mask) for pull-along-In traversal."""
        return self.src, self.dst, self.weight, self.edge_mask

    def out_edges(self):
        """(neighbor_id, self_id, weight, mask) for traversal of Out[v]; the
        segment key (second element) is the sorted transpose source."""
        return self.t_dst, self.t_src, self.t_weight, self.t_mask

    def edges(self, direction: str):
        if direction in ("in", "nbr"):
            return self.in_edges()
        if direction == "out":
            return self.out_edges()
        raise ValueError(f"unknown edge direction {direction!r}")

    def offsets(self, direction: str) -> torch.Tensor:
        """Segment offsets matching the segment key of :meth:`edges`."""
        if direction in ("in", "nbr"):
            return self.in_ptr
        if direction == "out":
            return self.out_ptr
        raise ValueError(f"unknown edge direction {direction!r}")

    def to(self, device) -> "Graph":
        """The same graph with every tensor moved to ``device``."""
        dev = resolve_device(device)
        moved = {
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)


def segment_offsets(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR row pointers ``i32[num_segments + 1]`` of ascending ``sorted_ids``:
    ``ptr[s]`` is the number of ids below ``s``, so rows ``ptr[s]:ptr[s+1]``
    are exactly the ids equal to ``s`` (negative and out-of-range ids fall
    outside every segment)."""
    bounds = torch.arange(
        num_segments + 1, dtype=sorted_ids.dtype, device=sorted_ids.device
    )
    return torch.searchsorted(sorted_ids, bounds, out_int32=True)


def _from_sorted(arrays: Dict[str, torch.Tensor], n_vertices: int) -> Graph:
    return Graph(
        **arrays,
        in_ptr=segment_offsets(arrays["dst"], n_vertices),
        out_ptr=segment_offsets(arrays["t_src"], n_vertices),
        n_vertices=int(n_vertices),
        n_edges=int(arrays["src"].shape[0]),
    )


def from_edge_list(
    src,
    dst,
    n_vertices: int,
    weight=None,
    pad_to: Optional[int] = None,
    device="cuda",
) -> Graph:
    """Build a :class:`Graph` from host-side edge arrays.

    Padding runs in numpy; the two stable sorts (by ``dst`` and by ``src``)
    run with torch on ``device``, which gives the same permutation as
    numpy's stable argsort. ``pad_to`` rounds the edge count up to a fixed
    size.
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if weight is None:
        weight = np.ones(src.shape, dtype=np.float32)
    weight = np.asarray(weight, dtype=np.float32)
    if src.shape != dst.shape or src.shape != weight.shape:
        raise ValueError("src/dst/weight must have identical shapes")
    if src.ndim != 1:
        raise ValueError("edge arrays must be rank-1")
    e = src.shape[0]
    n_edges = int(pad_to) if pad_to is not None else e
    if n_edges < e:
        raise ValueError(f"pad_to={pad_to} smaller than edge count {e}")

    sentinel = n_vertices
    pad = n_edges - e
    src_p = torch.from_numpy(
        np.concatenate([src, np.full((pad,), sentinel, np.int32)])
    ).to(dev)
    dst_p = torch.from_numpy(
        np.concatenate([dst, np.full((pad,), sentinel, np.int32)])
    ).to(dev)
    w_p = torch.from_numpy(
        np.concatenate([weight, np.zeros((pad,), np.float32)])
    ).to(dev)
    mask_p = torch.from_numpy(
        np.concatenate([np.ones((e,), bool), np.zeros((pad,), bool)])
    ).to(dev)

    by_dst = torch.sort(dst_p, stable=True).indices  # pull ordering
    by_src = torch.sort(src_p, stable=True).indices  # push ordering
    arrays = dict(
        src=src_p[by_dst],
        dst=dst_p[by_dst],
        weight=w_p[by_dst],
        edge_mask=mask_p[by_dst],
        t_src=src_p[by_src],
        t_dst=dst_p[by_src],
        t_weight=w_p[by_src],
        t_mask=mask_p[by_src],
    )
    return _from_sorted(arrays, n_vertices)


def as_field(value, device) -> torch.Tensor:
    """One field value as a tensor on ``device``, with the JAX package's
    x64-off dtypes: 64-bit ints become int32, float64 becomes float32."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value)
    )
    if t.dtype == torch.int64:
        t = t.to(torch.int32)
    elif t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(resolve_device(device))


def from_arrays(
    *,
    src,
    dst,
    weight,
    edge_mask,
    t_src,
    t_dst,
    t_weight,
    t_mask,
    n_vertices: int,
    device="cuda",
) -> Graph:
    """Build a :class:`Graph` from another graph's already-sorted leaves,
    given as numpy arrays (e.g. ``np.asarray`` of each array of a JAX
    ``repro.graph.Graph``). The orderings are taken as they are; only the
    segment offsets are computed."""
    dev = resolve_device(device)
    given = dict(
        src=src, dst=dst, weight=weight, edge_mask=edge_mask,
        t_src=t_src, t_dst=t_dst, t_weight=t_weight, t_mask=t_mask,
    )
    dtypes = dict(
        src=np.int32, dst=np.int32, weight=np.float32, edge_mask=bool,
        t_src=np.int32, t_dst=np.int32, t_weight=np.float32, t_mask=bool,
    )
    arrays = {
        k: torch.from_numpy(np.array(v, dtypes[k])).to(dev)
        for k, v in given.items()
    }
    return _from_sorted(arrays, n_vertices)


def fields_from_arrays(fields: Mapping[str, object], device="cuda"):
    """A field dict of numpy arrays (or array-likes) as tensors on
    ``device`` — the state carrier between the two packages."""
    return {k: as_field(v, device) for k, v in fields.items()}


def symmetrize(src, dst, weight=None):
    """Host-side: return the symmetric closure of an edge list (deduplicated).

    Palgol's ``Nbr`` field assumes every undirected edge is stored on both
    endpoints; the compiler relies on this symmetry (paper §3.2).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if weight is None:
        weight = np.ones(src.shape, dtype=np.float32)
    weight = np.asarray(weight, dtype=np.float32)
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    w = np.concatenate([weight, weight])
    # dedup parallel edges, keep first weight
    key = a * (max(int(b.max(initial=0)) + 1, 1)) + b
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return a[idx].astype(np.int32), b[idx].astype(np.int32), w[idx]


def pad_edges(graph: Graph, n_edges: int) -> Graph:
    """Re-pad a graph to a larger static edge count."""
    if n_edges < graph.n_edges:
        raise ValueError("cannot shrink edge array")
    keep = graph.edge_mask.cpu().numpy()
    return from_edge_list(
        graph.src.cpu().numpy()[keep],
        graph.dst.cpu().numpy()[keep],
        graph.n_vertices,
        graph.weight.cpu().numpy()[keep],
        pad_to=n_edges,
        device=graph.device,
    )
