"""Collectives of the models on a multi-rank mesh, with the gradients that
JAX's ``shard_map`` transposes give them.

The JAX package runs a mesh region as ``shard_map(..., check_rep=False)``;
the port runs one process per rank, each holding the replicated values
whole as plain tensors, and a region is that rank's share of the work
between two of the collectives below. Each is a ``torch.autograd.Function``
whose backward is the transpose JAX takes (``jax.experimental.shard_map``
without replication checks: an input unmapped over some axes gets the sum
of the ranks' cotangents, an output unmapped over some axes hands each rank
its cotangent divided by their size, ``psum``'s transpose is ``psum``):

* :func:`copy_in` — a replicated input entering a region: identity
  forward, ``all_reduce`` SUM of the cotangents backward;
* :func:`psum` — ``jax.lax.psum`` into a replicated output: ``all_reduce``
  SUM forward; backward each rank keeps its cotangent (every rank holds
  the same one, and JAX's ``psum(g / n)`` is ``g``);
* :func:`pmean` — ``jax.lax.pmean`` into a replicated output, backward the
  cotangent times ``ct_scale``;
* :func:`pminmax` — ``_diff_pminmax``: ``all_reduce`` MAX or MIN forward,
  ``g·hit / max(psum(hit), 1)`` backward, ``g`` first scaled by
  ``ct_scale`` (``1/n`` where the region's output is replicated, as JAX
  divides its cotangent);
* :func:`reduce_scatter_rows` — ``psum_scatter(tiled=True)`` over the
  leading dimension, backward an ``all_gather`` of the cotangents;
* :func:`all_gather_rows` — each rank's rows of a node-sharded result
  gathered into the replicated whole; backward this rank's rows of the
  (replicated) cotangent;
* :func:`all_gather_dim` — a parameter held as this rank's FSDP shard
  gathered whole along one dimension where it is used; backward a
  reduce-scatter of the cotangents along the same dimension, summed in
  float32 and averaged over the group (each rank's gradient is its share
  of the batch's), or this rank's slice of a cotangent every rank holds;
* :func:`all_gather_sum` — the tensor-parallel gather (Megatron's
  sequence-parallel ``g``): the sequence-split residual, or a weight held
  as this rank's ``model`` block, gathered whole along one dimension for a
  rank's share of the work; backward a reduce-scatter of the ranks'
  partial cotangents along it, summed in float32 and cast back;
* :func:`reduce_scatter_dim` — its transpose (``ḡ``): each rank's float32
  partial product reduce-scattered along one dimension (the sequence) and
  rounded once by the caller; backward an all-gather of the cotangents;
* :func:`own_block` — this rank's block of one dimension of a value every
  rank holds whole (the MoE's routed output on the sequence-split
  residual): no communication forward; backward the ranks' cotangents of
  their blocks all-gathered into the whole one, the cotangent of a
  replicated value;
* :func:`counted_once` — a value every rank computes whole from the same
  inputs, where the gradients its inputs receive are summed over the
  ranks: identity forward; backward the cotangent on the group's first
  rank and zeros on the others (no communication);
* :func:`pmax` — a cross-rank max with no gradient (the vocabulary-split
  cross-entropy's shift);
* :func:`all_to_all_dim` — blocks of one dimension sent rank to rank and
  received along another, no gradient: the prefill's K/V from a rank's
  heads to its cache slots.

Transport: the ranks of one card talk through gloo (NCCL refuses two
ranks on one device). On the H100 machine gloo took every collective here
on CUDA tensors — ``all_reduce`` SUM, MAX and MIN in f32, bf16 and int32,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, on subgroups too —
copying them through the host itself, so none is staged by the port
(:func:`transport` says so). DTensor's own redistributions (its functional
collectives) hung there on gloo with CUDA tensors, so no DTensor of the
port communicates: gathering one whole is :func:`full_tensor`, over these
collectives. ``COUNTS`` counts the calls and input bytes by collective,
and the bytes a rank puts on the wire by the ring formulas over the
call's own group (``<name>_wire_bytes``; ``roofline.analysis``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

#: calls and bytes by collective
COUNTS: Dict[str, int] = {}


def reset_counts() -> Dict[str, int]:
    out = dict(COUNTS)
    COUNTS.clear()
    return out


def _count(name: str, t: torch.Tensor, group=None):
    """One call of ``name`` on input ``t`` over ``group``: its input bytes,
    and its wire bytes a rank by the ring formula (an all-gather sends its
    output's other n − 1 parts, a reduce-scatter n − 1 parts of its input,
    an all-reduce both)."""
    nbytes = t.numel() * t.element_size()
    n = dist.get_world_size(group)
    wire = {"all_gather": nbytes * (n - 1), "reduce_scatter": nbytes * (n - 1) // n,
            "all_reduce": 2 * nbytes * (n - 1) // n, "all_to_all": nbytes * (n - 1) // n}[name]
    for key, value in ((name, 1), (f"{name}_bytes", nbytes), (f"{name}_wire_bytes", wire)):
        COUNTS[key] = COUNTS.get(key, 0) + value


def transport(group=None) -> str:
    """How the collectives on ``group`` travel."""
    backend = str(dist.get_backend(group))
    if backend == dist.Backend.GLOO:
        return "gloo (CUDA tensors copied through the host by gloo itself)"
    return backend


def _all_reduce_(t: torch.Tensor, op, group) -> torch.Tensor:
    _count("all_reduce", t, group)
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],) + t.shape[1:])
    _count("all_gather", t, group)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // dist.get_world_size(group),) + t.shape[1:])
    _count("reduce_scatter", t, group)
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def _rows(t: torch.Tensor, group) -> torch.Tensor:
    n = t.shape[0] // dist.get_world_size(group)
    r = dist.get_rank(group)
    return t[r * n:(r + 1) * n]


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.group), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ct_scale):
        ctx.ct_scale = ct_scale
        world = dist.get_world_size(group)
        if world == 1:
            return x.clone()
        return _all_reduce_(x.contiguous().clone(), dist.ReduceOp.SUM, group) / world

    @staticmethod
    def backward(ctx, g):
        return g * ctx.ct_scale, None, None


class _PMinMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, is_max, ct_scale):
        m = _all_reduce_(x.contiguous().clone(),
                         dist.ReduceOp.MAX if is_max else dist.ReduceOp.MIN, group)
        ctx.save_for_backward(x, m)
        ctx.group, ctx.ct_scale = group, ct_scale
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        hit = (x == m).to(g.dtype)
        cnt = torch.clamp(_all_reduce_(hit.clone(), dist.ReduceOp.SUM, ctx.group), min=1.0)
        return (g * ctx.ct_scale) * hit / cnt, None, None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _rows(g, ctx.group), None


def _all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _all_gather(x.movedim(dim, 0), group).movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _reduce_scatter(x.movedim(dim, 0), group).movedim(0, dim)


class _AllGatherDim(torch.autograd.Function):
    """``reduce`` says what the backward does with the cotangents:
    ``"mean"`` / ``"sum"`` reduce-scatter them in float32 (averaged or
    summed), ``"slice"`` takes this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group, reduce):
        ctx.dim, ctx.group, ctx.reduce = dim, group, reduce
        return _all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce == "slice":
            return _rows(g.movedim(ctx.dim, 0), ctx.group).movedim(0, ctx.dim), None, None, None
        out = _reduce_scatter_dim(g.float(), ctx.dim, ctx.group)
        if ctx.reduce == "mean":
            out = out / dist.get_world_size(ctx.group)
        return out.to(g.dtype), None, None, None


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, ctx.dim, ctx.group), None, None


class _OwnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _rows(x.movedim(dim, 0), group).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, ctx.dim, ctx.group), None, None


class _CountedOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.first = dist.get_rank(group) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated input of a region (see module)."""
    return _CopyIn.apply(x, group) if _grad(x) else x


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum`` of each rank's partial into a replicated result."""
    if _grad(x):
        return _PSum.apply(x, group)
    return _all_reduce_(x.contiguous().clone(), dist.ReduceOp.SUM, group)


def pmean(x: torch.Tensor, group, ct_scale: float) -> torch.Tensor:
    """``jax.lax.pmean`` into a replicated result; its cotangent is scaled
    by ``ct_scale`` on the way back."""
    return _PMean.apply(x, group, ct_scale)


def pminmax(x: torch.Tensor, group, is_max: bool, ct_scale: float = 1.0) -> torch.Tensor:
    """``_diff_pminmax``: the cross-rank max (or min) of each rank's partial,
    its cotangent split across the ranks that attain it."""
    if _grad(x):
        return _PMinMax.apply(x, group, is_max, ct_scale)
    op = dist.ReduceOp.MAX if is_max else dist.ReduceOp.MIN
    return _all_reduce_(x.contiguous().clone(), op, group)


def pmax_int(x: torch.Tensor, group, is_max: bool) -> torch.Tensor:
    """int32 ``pmax``/``pmin`` (no gradient): the ``or`` / ``and`` combiners."""
    op = dist.ReduceOp.MAX if is_max else dist.ReduceOp.MIN
    return _all_reduce_(x.to(torch.int32).contiguous().clone(), op, group)


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``psum_scatter(scatter_dimension=0, tiled=True)``: this rank's block
    of the leading dimension of the sum over ranks."""
    world = dist.get_world_size(group)
    if x.shape[0] % world:
        raise ValueError(f"tiled reduce_scatter operand scatter dimension size "
                         f"{x.shape[0]} must be divisible by shard_count {world}")
    return _ReduceScatterRows.apply(x, group) if _grad(x) else _reduce_scatter(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block of the leading dimension, in rank order."""
    return _AllGatherRows.apply(x, group) if _grad(x) else _all_gather(x, group)


def all_gather_dim(x: torch.Tensor, dim: int, group, mean: bool = True) -> torch.Tensor:
    """Every rank's block of dimension ``dim``, in rank order: an FSDP
    shard gathered whole. Backward (see module): with ``mean`` the
    cotangents reduce-scattered along ``dim`` in float32, divided by the
    group's size and cast back; without, this rank's block of the
    cotangent."""
    if _grad(x):
        return _AllGatherDim.apply(x, dim, group, "mean" if mean else "slice")
    return _all_gather_dim(x, dim, group)


def all_gather_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of dimension ``dim``, in rank order, where each
    rank uses the whole for its share of the work (a tensor-parallel
    region's input): backward the ranks' partial cotangents summed in
    float32, each rank keeping its block, cast back to ``x``'s dtype."""
    if _grad(x):
        return _AllGatherDim.apply(x, dim, group, "sum")
    return _all_gather_dim(x, dim, group)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of dimension ``dim`` of the sum over the group's
    ranks: a ZeRO-1 gradient onto its slice, or a tensor-parallel region's
    float32 partials onto this rank's block of the sequence. With a
    gradient its backward all-gathers the cotangents (:func:`all_gather_sum`'s
    transpose)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter dimension size {x.shape[dim]} must be divisible "
                         f"by shard_count {n}")
    if _grad(x):
        return _ReduceScatterDim.apply(x, dim, group)
    return _reduce_scatter_dim(x, dim, group)


def own_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of dimension ``dim`` of ``x``, which every rank of
    the group holds whole: with a gradient, its backward all-gathers the
    ranks' cotangents of their blocks (see module)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension size {x.shape[dim]} must be divisible by the group's "
                         f"{n} ranks")
    if _grad(x):
        return _OwnBlock.apply(x, dim, group)
    return _rows(x.movedim(dim, 0), group).movedim(0, dim)


def counted_once(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` computed alike on every rank of the group, its gradient kept on
    the first rank only (see module)."""
    return _CountedOnce.apply(x, group) if _grad(x) else x


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The cross-rank elementwise max of ``x``, no gradient."""
    return _all_reduce_(x.detach().contiguous().clone(), dist.ReduceOp.MAX, group)


def all_to_all_dim(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    """``x`` cut into ``n`` equal blocks along ``split``, block ``t`` sent
    to rank ``t``; the blocks received concatenated along ``concat`` in rank
    order (no gradient)."""
    n = dist.get_world_size(group)
    if x.shape[split] % n:
        raise ValueError(f"all_to_all dimension size {x.shape[split]} must be divisible "
                         f"by the group's {n} ranks")
    blocks = x.detach().movedim(split, 0)
    shape = blocks.shape
    blocks = blocks.reshape((n, shape[0] // n) + shape[1:]).contiguous()
    out = torch.empty_like(blocks)
    _count("all_to_all", blocks, group)
    dist.all_to_all_single(out, blocks, group=group)
    # [source rank, block, ...] with the block dimension back in place
    out = out.movedim(1, split + 1)
    return torch.cat(out.unbind(0), dim=concat)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a plain tensor, every rank the same) by the
    collectives above, mesh dimension by mesh dimension from the last (the
    nesting of DTensor's placements); a plain tensor comes back as it is.
    On a 1-D mesh the shards may be ragged (``torch.chunk``'s, as an edge
    dimension's are); on more dimensions they must be even (as
    ``dist.sharding.device_put`` makes them)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    mesh, t = x.device_mesh, x.to_local().detach()
    for dim in reversed(range(mesh.ndim)):
        placement = x.placements[dim]
        if isinstance(placement, Shard):
            d, size = placement.dim, x.shape[placement.dim]
            t = t.movedim(d, 0)
            if mesh.ndim == 1:  # torch.chunk's rows: ceil(size / n) a rank
                rows = -(-size // mesh.size())
                t = torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])
            t = _all_gather(t, mesh.get_group(dim))
            t = (t[:size] if mesh.ndim == 1 else t).movedim(0, d)
    return t.contiguous()
