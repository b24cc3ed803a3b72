"""GNN configuration covering the four assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    variant: str  # "sage" | "gat" | "pna" | "graphcast"
    n_layers: int
    d_hidden: int
    d_in: int
    n_out: int  # classes (classification) or output vars (regression)
    n_heads: int = 1  # gat
    aggregator: str = "mean"  # sage: mean/sum/max; gat ignores
    fanouts: Tuple[int, ...] = ()  # minibatch sampling (graphsage)
    d_edge: int = 0  # graphcast edge features
    task: str = "node_class"  # node_class | graph_class | regression
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # graphcast uses bf16 on huge graphs
    remat: bool = True  # checkpoint each layer (full-graph activations)
    # PNA
    pna_aggregators: Tuple[str, ...] = ("mean", "max", "min", "std")
    pna_scalers: Tuple[str, ...] = ("identity", "amplification", "attenuation")
    pna_delta: float = 2.5  # avg log-degree normalizer (dataset statistic)
