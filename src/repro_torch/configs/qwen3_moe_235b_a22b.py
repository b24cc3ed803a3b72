"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family]: 128 experts top-8."""

from repro_torch.configs.common import ArchSpec, FULL_ATTN_LONG_SKIP, LM_SHAPES
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def spec() -> ArchSpec:
    cfg = TransformerConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,  # unused (all layers MoE); kept for reporting parity
        vocab_size=151936,
        d_head=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    )
    reduced = TransformerConfig(
        name="qwen3-moe-reduced",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        d_head=16,
        qk_norm=True,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk_q=16,
        attn_chunk_kv=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32),
    )
    return ArchSpec(
        arch_id="qwen3-moe-235b-a22b",
        family="lm",
        config=cfg,
        reduced=reduced,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTN_LONG_SKIP},
        notes="Optimizer state dtype bf16 at the 235B scale (see DESIGN.md).",
    )
