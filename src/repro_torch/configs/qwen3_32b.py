"""qwen3-32b [hf:Qwen/Qwen3-8B family]: GQA kv=8, qk_norm, head_dim 128."""

from repro_torch.configs.common import ArchSpec, FULL_ATTN_LONG_SKIP, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def spec() -> ArchSpec:
    cfg = TransformerConfig(
        name="qwen3-32b",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        d_ff=25600,
        vocab_size=151936,
        d_head=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        attn_chunk_q=512,
        attn_chunk_kv=512,
    )
    reduced = TransformerConfig(
        name="qwen3-32b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        d_head=16,
        qk_norm=True,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk_q=16,
        attn_chunk_kv=16,
    )
    return ArchSpec(
        arch_id="qwen3-32b",
        family="lm",
        config=cfg,
        reduced=reduced,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTN_LONG_SKIP},
    )
