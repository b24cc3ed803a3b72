"""GAT-Cora [arXiv:1710.10903]: 2 layers, 8 heads, d_hidden 8, attn agg."""

from repro_torch.configs.common import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GNNConfig


def spec() -> ArchSpec:
    cfg = GNNConfig(
        name="gat-cora",
        variant="gat",
        n_layers=2,
        d_hidden=8,
        n_heads=8,
        d_in=-1,
        n_out=-1,
    )
    reduced = GNNConfig(
        name="gat-reduced", variant="gat", n_layers=2, d_hidden=4, n_heads=2,
        d_in=6, n_out=3,
    )
    return ArchSpec(
        arch_id="gat-cora", family="gnn", config=cfg, reduced=reduced,
        shapes=GNN_SHAPES,
    )
