"""h2o-danube-1.8b [arXiv:2401.16818]: llama+mistral mix with SWA, GQA kv=8."""

from repro_torch.configs.common import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def spec() -> ArchSpec:
    cfg = TransformerConfig(
        name="h2o-danube-1.8b",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        d_head=80,
        swa_window=4096,  # sliding-window attention (mistral-style)
        rope_theta=10_000.0,
    )
    reduced = TransformerConfig(
        name="h2o-danube-reduced",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        d_head=8,
        swa_window=32,
        rope_theta=10_000.0,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk_q=16,
        attn_chunk_kv=16,
    )
    return ArchSpec(
        arch_id="h2o-danube-1.8b",
        family="lm",
        config=cfg,
        reduced=reduced,
        shapes=LM_SHAPES,
        notes="SWA ⇒ sub-quadratic: long_500k decode runs with a "
        "window-bounded (4096) KV ring buffer.",
    )
