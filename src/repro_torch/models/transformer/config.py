"""Transformer configuration (covers all assigned LM architectures).

The JAX package's ``repro.models.transformer.config``, with ``pdtype`` and
``cdtype`` as ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: Optional[int] = None  # defaults to d_ff_expert × n_shared
    capacity_factor: float = 1.25
    router_dtype: str = "float32"

    @property
    def shared_ff(self) -> int:
        if self.d_ff_shared is not None:
            return self.d_ff_shared
        return self.d_ff_expert * max(self.n_shared_experts, 1)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    swa_window: Optional[int] = None  # sliding-window attention (h2o-danube)
    rope_theta: float = 1_000_000.0
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # attention implementation: "dense" scores or "chunked" online-softmax
    attn_impl: str = "chunked"
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    remat: bool = True
    scan_unroll: int = 1  # layer-scan unroll (dry-run flops probes use L=2)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def n_params(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS and roofline)."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        if self.moe is None:
            ffn = 3 * d * self.d_ff
        else:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            ffn += d * self.moe.n_experts  # router
            if self.moe.n_shared_experts:
                ffn += 3 * d * self.moe.shared_ff
        norms = 2 * d
        per_layer = attn + ffn + norms
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d

    def n_active_params(self) -> int:
        """Active (per-token) parameters — MoE counts top_k + shared only."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        ffn = self.moe.top_k * 3 * d * self.moe.d_ff_expert
        ffn += d * self.moe.n_experts
        if self.moe.n_shared_experts:
            ffn += 3 * d * self.moe.shared_ff
        per_layer = attn + ffn + 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d
