"""EmbeddingBag over torch tensors, in the JAX package's two layouts.

* fixed-width bags ``[B, H]`` indices (+ optional weights and mask):
  ``sum`` and ``mean`` are one ``kernels.embedding_bag`` call (the CUDA
  kernel on the card); ``max`` is plain tensor code, as in the JAX package;
* ragged bags — flat indices ``[T]`` + sorted bag ids: the port's
  ``graph.ops.gather`` and ``segment_reduce`` (the gather_rows and
  segment_reduce kernels on the card).

Indices are clipped to the table (``jnp.take(mode="clip")``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.graph import ops as gops
from repro_torch.kernels.embedding_bag import embedding_bag as bag_kernel


def embedding_bag(
    table: torch.Tensor,  # [V, D]
    indices: torch.Tensor,  # [B, H] int32
    weights: Optional[torch.Tensor] = None,  # [B, H]
    mask: Optional[torch.Tensor] = None,  # [B, H] bool
    mode: str = "sum",
) -> torch.Tensor:
    """Fixed-width multi-hot bag lookup → [B, D]."""
    if mode in ("sum", "mean"):
        out = bag_kernel(table, indices, weights, mask)
        if mode == "sum":
            return out
        if mask is not None:
            denom = mask.sum(dim=1, keepdim=True).to(out.dtype)
        else:
            denom = torch.tensor(indices.shape[1], dtype=out.dtype, device=out.device)
        return out / denom.clamp(min=1.0)
    if mode == "max":
        v = table.shape[0]
        vals = table[indices.long().clamp(0, v - 1)]  # [B, H, D]
        if weights is not None:
            vals = vals * weights[..., None].to(vals.dtype)
        if mask is not None:
            vals = vals * mask[..., None].to(vals.dtype)
            vals = torch.where(mask[..., None], vals, -torch.inf)
        out = vals.amax(dim=1)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(mode)


def embedding_bag_ragged(
    table: torch.Tensor,  # [V, D]
    flat_indices: torch.Tensor,  # [T]
    bag_ids: torch.Tensor,  # [T]  (sorted bag id per index)
    n_bags: int,
    weights: Optional[torch.Tensor] = None,  # [T]
    mode: str = "sum",
) -> torch.Tensor:
    """Ragged bag lookup (CSR-offsets style) → [n_bags, D]."""
    vals = gops.gather(table, flat_indices)  # clipped, [T, D]
    if weights is not None:
        vals = vals * weights[:, None].to(vals.dtype)
    if mode == "sum":
        return gops.segment_reduce(vals, bag_ids, n_bags, "sum", indices_are_sorted=True)
    if mode == "mean":
        s = gops.segment_reduce(vals, bag_ids, n_bags, "sum", indices_are_sorted=True)
        ones = torch.ones(flat_indices.shape, dtype=vals.dtype, device=vals.device)
        cnt = gops.segment_reduce(ones, bag_ids, n_bags, "sum", indices_are_sorted=True)
        return s / cnt[:, None].clamp(min=1.0)
    if mode == "max":
        out = gops.segment_reduce(vals, bag_ids, n_bags, "max", indices_are_sorted=True)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(mode)
