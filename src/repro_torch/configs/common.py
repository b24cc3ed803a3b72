"""Arch/shape registry dataclasses + the assigned shape tables."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

# ---------------------------------------------------------------------------
# shape tables (verbatim from the assignment)

LM_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq_len=4_096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32_768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524_288, global_batch=1),
}

GNN_SHAPES: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": dict(
        kind="full_graph", n_nodes=2_708, n_edges=10_556, d_feat=1_433
    ),
    "minibatch_lg": dict(
        kind="minibatch",
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1_024,
        fanouts=(15, 10),
        d_feat=602,  # Reddit features
    ),
    "ogb_products": dict(
        kind="full_graph", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100
    ),
    "molecule": dict(
        kind="batched_graphs", n_nodes=30, n_edges=64, batch=128, d_feat=32
    ),
}

RECSYS_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

# classes per GNN shape (dataset-realistic)
GNN_SHAPE_CLASSES = {
    "full_graph_sm": 7,  # cora
    "minibatch_lg": 41,  # reddit
    "ogb_products": 47,
    "molecule": 10,
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys"
    config: Any
    reduced: Any  # small config for CPU smoke tests
    shapes: Dict[str, Dict[str, Any]]
    # cells skipped per harness rules: shape_id → reason
    skips: Dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""

    def cells(self):
        for shape_id in self.shapes:
            yield shape_id, self.shapes[shape_id], self.skips.get(shape_id)


FULL_ATTN_LONG_SKIP = (
    "long_500k skipped: pure full attention (no sub-quadratic mechanism); "
    "see DESIGN.md §5"
)
