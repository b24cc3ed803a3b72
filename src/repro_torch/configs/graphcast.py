"""GraphCast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN."""

from repro_torch.configs.common import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GNNConfig


def spec() -> ArchSpec:
    cfg = GNNConfig(
        name="graphcast",
        variant="graphcast",
        n_layers=16,
        d_hidden=512,
        d_in=-1,  # per-shape d_feat (precomputed frame embeddings)
        n_out=227,  # n_vars
        d_edge=512,
        task="regression",
        compute_dtype="bfloat16",  # 62M-edge x 512 activations: bf16 halves
        # the per-layer edge-feature footprint (loss/head stay fp32)
    )
    reduced = GNNConfig(
        name="graphcast-reduced", variant="graphcast", n_layers=2,
        d_hidden=16, d_in=6, n_out=5, d_edge=16, task="regression",
    )
    return ArchSpec(
        arch_id="graphcast", family="gnn", config=cfg, reduced=reduced,
        shapes=GNN_SHAPES,
        notes="mesh_refinement=6 icosahedral mesh replaced by the shape's "
        "graph (the processor is topology-agnostic); regression over 227 vars.",
    )
