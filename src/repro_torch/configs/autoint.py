"""AutoInt [arXiv:1810.11921]: 39 sparse fields, 3 self-attn layers."""

from repro_torch.configs.common import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import AutoIntConfig


def spec() -> ArchSpec:
    cfg = AutoIntConfig(
        name="autoint",
        n_fields=39,
        embed_dim=16,
        n_attn_layers=3,
        n_heads=2,
        d_attn=32,
        vocab_per_field=1_000_000,
    )
    reduced = AutoIntConfig(
        name="autoint-reduced",
        n_fields=8,
        embed_dim=8,
        n_attn_layers=2,
        n_heads=2,
        d_attn=16,
        vocab_per_field=1_000,
        mlp_dims=(32,),
    )
    return ArchSpec(
        arch_id="autoint", family="recsys", config=cfg, reduced=reduced,
        shapes=RECSYS_SHAPES,
    )
