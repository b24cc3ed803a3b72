"""GraphSAGE-Reddit [arXiv:1706.02216]: 2 layers, mean agg, fanout 25-10."""

from repro_torch.configs.common import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GNNConfig


def spec() -> ArchSpec:
    cfg = GNNConfig(
        name="graphsage-reddit",
        variant="sage",
        n_layers=2,
        d_hidden=128,
        d_in=-1,
        n_out=-1,
        aggregator="mean",
        fanouts=(25, 10),
    )
    reduced = GNNConfig(
        name="sage-reduced", variant="sage", n_layers=2, d_hidden=8, d_in=6,
        n_out=3, fanouts=(5, 3),
    )
    return ArchSpec(
        arch_id="graphsage-reddit", family="gnn", config=cfg, reduced=reduced,
        shapes=GNN_SHAPES,
        notes="minibatch_lg uses the native sampler fanouts (25,10) from the "
        "arch (shape's 15-10 applies to the generic sampled-subgraph path).",
    )
