"""PNA [arXiv:2004.05718]: multi-aggregator (mean/max/min/std) × scalers."""

from repro_torch.configs.common import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GNNConfig


def spec() -> ArchSpec:
    cfg = GNNConfig(
        name="pna",
        variant="pna",
        n_layers=4,
        d_hidden=75,
        d_in=-1,  # set per shape (d_feat)
        n_out=-1,  # set per shape (classes)
        pna_aggregators=("mean", "max", "min", "std"),
        pna_scalers=("identity", "amplification", "attenuation"),
        compute_dtype="bfloat16",  # 62M-edge messages; head/loss stay fp32
    )
    reduced = GNNConfig(
        name="pna-reduced", variant="pna", n_layers=2, d_hidden=8, d_in=6,
        n_out=3,
    )
    return ArchSpec(
        arch_id="pna", family="gnn", config=cfg, reduced=reduced,
        shapes=GNN_SHAPES,
    )
