"""AutoInt configuration (arXiv:1810.11921)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str
    n_fields: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32  # total attention width (d_head = d_attn / n_heads)
    vocab_per_field: int = 1_000_000  # hashed vocabulary rows per field
    mlp_dims: Tuple[int, ...] = (400, 400)
    param_dtype: str = "float32"

    @property
    def d_head(self) -> int:
        return self.d_attn // self.n_heads
