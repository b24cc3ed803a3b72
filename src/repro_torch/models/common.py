"""Shared NN building blocks (functional, on torch tensors).

``repro.models.common`` on torch tensors, the losses with gradients in
float32 as there. The JAX package's ``optimization_barrier`` needs no
counterpart: it is the identity, there to stop XLA's loop-invariant code
motion from hoisting an f32 upcast of the remat carry out of the backward
scan, and PyTorch runs each layer eagerly, with no such pass.
The models call ``dist.sharding.constrain`` where the JAX models do;
this module, as JAX's, calls none. Two blocks serve the dense LM's tensor
parallelism: :func:`partial_matmul`, a rank's share of a product in
float32 (its partials summed across ranks in float32 and rounded once),
and the vocabulary-split :func:`softmax_cross_entropy`, whose max,
sum-exp and gold logit are reduced over the ranks in float32.
Random initialisers draw from an explicit ``torch.Generator``, whose device
is where the parameters are made. :func:`abstract_like` runs one under
``FakeTensorMode`` (the dry-run's parameters: shapes and dtypes, nothing
allocated) and :func:`count_params` counts a tree's elements.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode


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


class _PartialMatmul(torch.autograd.Function):
    """``a @ w`` of bf16 (or f16) operands accumulated and returned in
    float32, unrounded; the backward takes the cotangent in the operands'
    dtype, as the one-rank product's backward does."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1])
        if a.is_cuda or isinstance(a, FakeTensor):  # a dry-run traces the card's product
            out = torch.mm(a2, w, out_dtype=torch.float32)
        else:
            out = a2.float() @ w.float()
        return out.reshape(a.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ w.T if ctx.needs_input_grad[0] else None
        gw = (a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return ga, gw


def partial_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ w [K, N]`` in float32: a rank's partial product of a
    row-parallel layer, which the ranks sum in float32 before it is rounded
    once. float32 operands take the plain product."""
    if a.dtype == torch.float32:
        return a @ w
    return _PartialMatmul.apply(a, w)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: Optional[tuple] = None) -> torch.Tensor:
    """Token-mean cross-entropy; logits ``[..., V]`` taken in float32 (the
    gradient ``softmax − onehot`` over the token count, in float32).

    ``vocab = (first, group)``: ``logits`` are this rank's block of the
    vocabulary, ids ``first…`` (tensor parallelism); the max (a shift, no
    gradient), the sum of exponentials and the gold logit are reduced over
    ``group`` in float32, so no rank holds the ``[..., V]`` logits whole,
    and each rank's block gets ``softmax − onehot`` of its own ids."""
    logits = logits.float()
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return (lse - gold).mean()
    from repro_torch.dist import collectives as coll

    first, group = vocab
    n = logits.shape[-1]
    shift = coll.pmax(logits.detach().amax(dim=-1), group)
    lse = coll.psum(torch.exp(logits - shift[..., None]).sum(dim=-1), group).log() + shift
    ids = labels.long() - first
    inside = (ids >= 0) & (ids < n)
    gold = logits.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
    gold = coll.psum(torch.where(inside, gold, 0.0), group)
    return (lse - gold).mean()


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    labels = labels.float()
    return (
        logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    ).mean()


def fake_mode(tensors=None) -> FakeTensorMode:
    """The active ``FakeTensorMode`` (the dry-run's), else the one the fake
    ``tensors`` (a list) belong to, else a new one."""
    return detect_fake_mode(tensors) or FakeTensorMode()


def fake_tensor(shape, dtype, device="cuda") -> torch.Tensor:
    """A fake tensor of ``shape`` and ``dtype`` on ``device`` in
    :func:`fake_mode`: a dry-run spec, with no memory behind it."""
    with fake_mode():
        return torch.empty(tuple(shape), dtype=dtype, device=device)


def map_tensors(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``tree`` with ``fn`` applied to every tensor leaf, in the same nesting
    of dicts, lists and tuples (``None`` stays); a module is rebuilt by its
    own ``map_tensors(fn)``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "map_tensors"):
        return tree.map_tensors(fn)
    if isinstance(tree, Mapping):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def abstract_like(init_fn: Callable, *args, device="cuda", **kwargs) -> Any:
    """The tree ``init_fn(*args, **kwargs)`` makes, with nothing allocated:
    the initialiser runs on the CPU under :func:`fake_mode` (its draws read
    no bits) and each leaf becomes a fake tensor on ``device`` of the same
    shape, dtype and ``requires_grad``. ``init_fn`` takes ``device=``."""
    with fake_mode():
        tree = init_fn(*args, device="cpu", **kwargs)
        if torch.device(device).type == "cpu":
            return tree

        def move(t):
            out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)
            return out.requires_grad_(t.requires_grad)

        return map_tensors(tree, move)


def count_params(tree: Any) -> int:
    """The elements of every tensor leaf of ``tree`` (a module's parameters)."""
    if tree is None:
        return 0
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, Mapping):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return 0
