"""The four kernels with gradients: ``torch.autograd.Function``s around the
wrappers of ``gather_rows``, ``segment_reduce``, ``embedding_bag`` and
``flash_attention``.

Each function here takes the arguments of its kernel's wrapper. When no
gradient is wanted (``torch.no_grad()``, or no float input that requires
one) it is that wrapper, launches and counts unchanged; otherwise it runs
the same forward inside a ``Function`` whose backward runs on the port's
own kernels on the card (their plain versions on the CPU, where the
wrappers take them), never on PyTorch's autograd of the plain version:

* ``flash_attention``: the forward also returns the f32 logsumexp, and
  ``csrc/flash_attention_bwd.cu`` computes ``dq, dk, dv`` from it, as the
  JAX package's custom VJP ``_flash_bwd`` does;
* ``gather_rows``: the table's gradient is a sum of the cotangent's rows
  by their (clipped, or in fill mode wrapped and dropped) index:
  :func:`scatter_rows`, a stable sort of the int32 ids, ``gather_rows`` of
  the cotangent in that order, and ``segment_reduce`` sum over the sorted
  ids' offsets — deterministic, hubs on the existing routes;
* ``segment_reduce``: sum's backward is ``gather_rows`` of the cotangent
  by segment id (0 for masked rows and ids outside ``[0, n)``); max and
  min route the cotangent to the rows equal to the result, split evenly
  across ties with JAX's rule (``jax.lax`` scatter max/min: a segment
  whose result is the combiner's identity counts the initial value as one
  more tie); prod, or and and have no gradient here and raise;
* ``embedding_bag``: the table's gradient is :func:`scatter_rows` of each
  slot's bag cotangent times the slot's weight; the weights' gradient is
  the dot of each slot's table row (``gather_rows``) with its bag's
  cotangent.

bf16 sums accumulate in f32 and round once (the port's segment sum), where
JAX's scatter-add of a bf16 gradient accumulates in bf16.
"""

from __future__ import annotations

import math

import torch

from repro_torch.graph.structure import segment_offsets
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gather_rows import ops as gather_ops
from repro_torch.kernels.segment_reduce import ops as segment_ops


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad and t.is_floating_point() for t in tensors
    )


def scatter_rows(values: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """``out[r] = Σ values[i]`` over ``rows[i] == r``, ``out [n, ...]``;
    rows outside ``[0, n)`` are dropped. A stable sort of the int32 rows,
    ``gather_rows`` of ``values`` in that order and ``segment_reduce`` sum
    over the sorted rows' offsets, so the sum runs in a fixed order."""
    rows = rows.reshape(-1).to(torch.int32)
    sorted_rows, perm = torch.sort(rows, stable=True)
    ordered = gather_ops.gather_rows(values.contiguous(), perm.to(torch.int32))
    offsets = segment_offsets(sorted_rows, n) if values.device.type == "cuda" else None
    return segment_ops.segment_reduce(ordered, sorted_rows, n, "sum", offsets=offsets)


def gather_rows_backward(g, idx, n_rows: int, fill) -> torch.Tensor:
    """The table's gradient of ``gather_rows(table, idx, fill)`` for the
    output's cotangent ``g``: clip mode clamps each id into the table,
    fill mode wraps ``[-n, -1]`` and drops the rest (they read ``fill``)."""
    idx = idx.reshape(-1).to(torch.int32)
    if fill is None:
        rows = idx.clamp(0, max(n_rows - 1, 0))
    else:
        rows = torch.where(idx < 0, idx + n_rows, idx)
    gather_rows_backward.calls += 1
    return scatter_rows(g, rows, n_rows)


gather_rows_backward.calls = 0


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, fill):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.fill = table.shape[0], fill
        return gather_ops.gather_rows(table, idx, fill)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows_backward(g, idx, ctx.n_rows, ctx.fill), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor, fill=None) -> torch.Tensor:
    """``kernels.gather_rows`` with the table's gradient."""
    if not _wants_grad(table):
        return gather_ops.gather_rows(table, idx, fill)
    return _GatherRows.apply(table, idx, fill)


def _in_segment(segment_ids, n, mask):
    """int32 ids with every row outside ``[0, n)`` or masked off at ``n``."""
    ok = (segment_ids >= 0) & (segment_ids < n)
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, segment_ids, n).to(torch.int32).contiguous()


def segment_reduce_backward(g, values, out, segment_ids, n, op, mask, offsets):
    """The values' gradient of ``segment_reduce`` for the cotangent ``g``
    (sum reads neither ``values`` nor ``out``)."""
    segment_reduce_backward.calls += 1
    g = g.contiguous()
    if op == "sum":
        return gather_ops.gather_rows(g, _in_segment(segment_ids, n, mask), 0.0)
    if op not in ("max", "min"):
        raise NotImplementedError(f"segment_reduce {op!r} has no gradient in the port")
    ident = segment_ops.identity(op, values.dtype)
    rows = _in_segment(segment_ids, n, None)
    eff = values
    if mask is not None:  # JAX reduces the identity in place of a masked row
        eff = torch.where(mask.reshape(mask.shape + (1,) * (values.ndim - 1)), values, ident)
    ties = eff == gather_ops.gather_rows(out.contiguous(), rows, math.nan)
    count = segment_ops.segment_reduce(
        ties.to(torch.float32).contiguous(), segment_ids, n, "sum", offsets=offsets)
    count = count + (out == ident).to(torch.float32)
    coef = g.float() * torch.where(count > 0, 1.0 / count, 0.0)
    share = gather_ops.gather_rows(coef.contiguous(), rows, 0.0)
    if mask is not None:
        ties = ties & mask.reshape(mask.shape + (1,) * (values.ndim - 1))
    return torch.where(ties, share, 0.0).to(values.dtype)


segment_reduce_backward.calls = 0


class _SegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segment_ids, num_segments, op, mask, offsets):
        out = segment_ops.segment_reduce(values, segment_ids, num_segments, op,
                                         mask=mask, offsets=offsets)
        extremum = (values, out) if op in ("max", "min") else (None, None)
        ctx.save_for_backward(*extremum, segment_ids, mask, offsets)
        ctx.n, ctx.op = num_segments, op
        return out

    @staticmethod
    def backward(ctx, g):
        values, out, ids, mask, offsets = ctx.saved_tensors
        dv = segment_reduce_backward(g, values, out, ids, ctx.n, ctx.op, mask, offsets)
        return dv, None, None, None, None, None


def segment_reduce(values, segment_ids, num_segments: int, op: str, mask=None,
                   offsets=None):
    """``kernels.segment_reduce`` with the values' gradient (sum, max,
    min)."""
    if not _wants_grad(values):
        return segment_ops.segment_reduce(values, segment_ids, num_segments, op,
                                          mask=mask, offsets=offsets)
    return _SegmentReduce.apply(values, segment_ids, num_segments, op, mask, offsets)


def embedding_bag_backward(g, table, indices, w):
    """``(d_table, d_w)`` of ``embedding_bag(table, indices, w)`` (``w`` the
    folded per-slot weights in the table's dtype, or ``None``)."""
    embedding_bag_backward.calls += 1
    v = table.shape[0]
    b, h = indices.shape
    rows = indices.reshape(-1).to(torch.int32).clamp(0, v - 1)
    g = g.contiguous()
    sorted_rows, perm = torch.sort(rows, stable=True)
    bag = torch.div(perm, h, rounding_mode="floor").to(torch.int32)
    slot_g = gather_ops.gather_rows(g, bag)  # each sorted slot's bag cotangent
    if w is not None:
        slot_g = (slot_g * w.reshape(-1)[perm][:, None]).to(table.dtype)
    offsets = segment_offsets(sorted_rows, v) if table.device.type == "cuda" else None
    d_table = segment_ops.segment_reduce(slot_g.contiguous(), sorted_rows, v, "sum",
                                         offsets=offsets)
    d_w = None
    if w is not None:
        vals = gather_ops.gather_rows(table, rows)  # [B·H, D]
        g_slot = g.reshape(b, 1, -1).expand(b, h, g.shape[-1]).reshape(b * h, -1)
        d_w = (vals * g_slot).sum(dim=-1).reshape(b, h).to(w.dtype)
    return d_table, d_w


embedding_bag_backward.calls = 0


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, w):
        ctx.save_for_backward(table, indices, w)
        return bag_ops.embedding_bag(table, indices, w)

    @staticmethod
    def backward(ctx, g):
        table, indices, w = ctx.saved_tensors
        d_table, d_w = embedding_bag_backward(g, table, indices, w)
        return d_table, None, d_w


def embedding_bag(table, indices, weights=None, mask=None):
    """``kernels.embedding_bag`` with the table's and the weights'
    gradients (the mask folds into the weights, as the wrapper does)."""
    if not _wants_grad(table, weights):
        return bag_ops.embedding_bag(table, indices, weights, mask)
    w = bag_ops.bag_weights(table, indices, weights, mask)
    return _EmbeddingBag.apply(table, indices, w)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, round_scores):
        out, lse = flash_ops.flash_attention(q, k, v, causal, window, scale,
                                             return_lse=True, round_scores=round_scores)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, round_scores)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_ops.flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                                   *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, window=None, scale=1.0, round_scores=False):
    """``kernels.flash_attention`` with the gradients of q, k and v."""
    if not _wants_grad(q, k, v):
        return flash_ops.flash_attention(q, k, v, causal, window, scale,
                                         round_scores=round_scores)
    return _FlashAttention.apply(q, k, v, causal, window, scale, round_scores)
