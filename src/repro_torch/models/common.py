"""Shared NN building blocks (functional, on torch tensors).

``repro.models.common`` on torch tensors, the losses with gradients in
float32 as there. The JAX package's ``optimization_barrier`` needs no
counterpart: it is the identity, there to stop XLA's loop-invariant code
motion from hoisting an f32 upcast of the remat carry out of the backward
scan, and PyTorch runs each layer eagerly, with no such pass.
The models call ``dist.sharding.constrain`` where the JAX models do;
this module, as JAX's, calls none.
Random initialisers draw from an explicit ``torch.Generator``, whose device
is where the parameters are made.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(
    gen: torch.Generator, d_in: int, d_out: int, dtype, scale: Optional[float] = None
) -> torch.Tensor:
    """``normal(d_in, d_out) * scale`` in float32, cast to ``dtype``;
    ``scale`` defaults to ``1 / sqrt(d_in)``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    x = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (x * scale).to(dtype)


def tensors_from_arrays(tree: Any, device: torch.device) -> Any:
    """A JAX parameter tree (each leaf a numpy array) as tensors on
    ``device``, in the same nesting of dicts and lists (``None`` stays)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tensors_from_arrays(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors_from_arrays(v, device) for v in tree]
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def trainable(tree: Any) -> Any:
    """Every floating leaf of a parameter tree set to require gradients
    (in place); returns the tree."""
    if isinstance(tree, Mapping):
        for v in tree.values():
            trainable(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            trainable(v)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        tree.requires_grad_(True)
    return tree


def stack_init(n: int, init_fn: Callable[[], Dict[str, torch.Tensor]]):
    """Call ``init_fn`` ``n`` times and stack each leaf along a new axis 0
    (the layer-stacked layout of the JAX package's ``stack_init``). Each
    ``[n, ...]`` leaf is allocated once and filled layer by layer, so the
    peak is the stacked leaves plus one layer, not twice the leaves."""
    out = {}
    for i in range(n):
        for name, t in init_fn().items():
            if i == 0:
                out[name] = t.new_empty((n,) + t.shape)
            out[name][i] = t
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back to ``x``'s dtype, then scale by
    ``gamma`` — the JAX package's order of rounding."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def swiglu(x, w1, w3, w2):
    """SwiGLU FFN: (silu(x@w1) * (x@w3)) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross-entropy; logits ``[..., V]`` taken in float32 (the
    gradient ``softmax − onehot`` over the token count, in float32)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    labels = labels.float()
    return (
        logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    ).mean()
