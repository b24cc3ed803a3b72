"""deepseek-moe-16b [arXiv:2401.06066]: 2 shared + 64 routed top-6, MHA."""

from repro_torch.configs.common import ArchSpec, FULL_ATTN_LONG_SKIP, LM_SHAPES
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def spec() -> ArchSpec:
    cfg = TransformerConfig(
        name="deepseek-moe-16b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,  # MHA (kv == heads)
        d_ff=1408,
        vocab_size=102400,
        d_head=128,
        rope_theta=10_000.0,
        moe=MoEConfig(
            n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2
        ),
    )
    reduced = TransformerConfig(
        name="deepseek-moe-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        d_head=16,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk_q=16,
        attn_chunk_kv=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1),
    )
    return ArchSpec(
        arch_id="deepseek-moe-16b",
        family="lm",
        config=cfg,
        reduced=reduced,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTN_LONG_SKIP},
        notes="Paper's layer-0 dense FFN simplified to MoE everywhere "
        "(noted in DESIGN.md deviations).",
    )
