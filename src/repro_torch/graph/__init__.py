"""Graph substrate on torch: sorted-COO graph with segment offsets + the
segment/gather/scatter ops whose hot paths are the CUDA kernels of
``repro_torch.kernels``. Counterpart of ``repro.graph``."""

from repro_torch.graph.structure import Graph, from_edge_list, symmetrize, pad_edges
from repro_torch.graph.ops import (
    segment_reduce,
    gather,
    scatter_combine,
    edge_softmax,
    out_degrees,
    in_degrees,
    COMBINE_IDENTITY,
)

__all__ = [
    "Graph",
    "from_edge_list",
    "symmetrize",
    "pad_edges",
    "segment_reduce",
    "gather",
    "scatter_combine",
    "edge_softmax",
    "out_degrees",
    "in_degrees",
    "COMBINE_IDENTITY",
]
