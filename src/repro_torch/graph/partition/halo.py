"""Halo-exchange collectives for partitioned vertex state.

The port of ``repro.graph.partition.halo``. The JAX functions run inside
a ``shard_map``; here each runs in one process per shard (SPMD over
``torch.distributed``), on that shard's blocks (no leading ``[S]``
dimension). ``jax.lax.all_to_all(x, split_axis=0, concat_axis=0)`` on an
``[S, K, ...]`` block is ``dist.all_to_all_single`` on the same contiguous
block with equal splits: in both, block ``j`` of the output is what shard
``j`` sent. ``psum_scatter`` is ``dist.reduce_scatter_tensor``. With
``group=None`` there is one shard and no collective runs. Which backend
carries the collectives (gloo for CPU tensors and for several ranks on one
card, NCCL for one rank per card) is the process group's business.

Three communication primitives cover all of Palgol's remote data access:

``halo_exchange``
    Static ghost reads: the owner gathers the boundary values its neighbors
    need (``send_local``), one ``all_to_all`` moves them, the reader
    scatters them into its ghost buffer (``recv_pos``). Per superstep this
    moves only the halo — O(boundary), not O(N). Used for neighborhood
    communication (``F[e.id]``), whose access set is the static edge
    structure.

``gather_global``
    Dynamic one-sided reads at arbitrary global vertex ids (chain access:
    ``D[D[u]]``): requests are bucketed by owner, one ``all_to_all`` ships
    the request ids, owners gather locally, a second ``all_to_all`` ships
    the replies. Pull-mode pointer doubling calls this once per doubling
    round — the request set is rebuilt from the *current* indirection
    field each round.

``scatter_reduce``
    Remote writes (``remote F[t] op= v``): each shard pre-combines its
    messages into an identity-filled ``[S·v_max]`` buffer, then a
    reduce-scatter (for ``sum``; ``all_to_all`` + a local fold for the
    other monoids) lands each owner's combined delta.

Every index goes through the port's ``graph.ops`` helpers, which keep the
JAX package's per-op index rules: the clip-mode ``gather`` (padded request
slots ``v_max`` read row ``v_max - 1``, never consumed) and the drop-mode
scatters. Ids stay int32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.graph import ops as gops
from repro_torch.kernels.gather_rows import ops as gather_kernel


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of the result is block ``j`` of shard ``j``'s ``x``
    (``jax.lax.all_to_all`` with ``split_axis=concat_axis=0``)."""
    if group is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def halo_exchange(
    x: torch.Tensor,  # [v_max, ...] per-shard field block
    send_local: torch.Tensor,  # i32[S, Hp] owner-local rows to send, per reader
    recv_pos: torch.Tensor,  # i32[S, Hp] ghost-buffer slots, per owner
    n_ghost: int,
    group=None,
) -> torch.Tensor:
    """Static halo gather → ghost values ``[n_ghost, ...]`` for this shard."""
    if n_ghost == 0:
        return x.new_zeros((0,) + x.shape[1:])
    vals = gops.gather(x, send_local)  # [S, Hp, ...] (pad rows clip: unread)
    recv = _all_to_all(vals, group)
    ghost = x.new_zeros((n_ghost + 1,) + x.shape[1:])
    ghost = gops.scatter_set(
        ghost, recv_pos.reshape(-1), recv.reshape((-1,) + x.shape[1:])
    )
    return ghost[:n_ghost]


def _owner_of(idx: torch.Tensor, starts: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard of each (already clipped) global vertex id."""
    pos = torch.searchsorted(starts, idx, right=True, out_int32=True)
    return torch.clamp(pos - 1, 0, n_shards - 1)


def _owner_and_slot(idx: torch.Tensor, starts: torch.Tensor, n_shards: int):
    """Owner shard and within-bucket slot for each (clipped) global id."""
    owner = _owner_of(idx, starts, n_shards)
    shards = torch.arange(n_shards, dtype=torch.int32, device=idx.device)
    # [S, K], scanned along its rows: on the card a scan along the outer
    # dimension of [K, S] runs S sequential passes over K
    onehot = (shards[:, None] == owner[None, :]).to(torch.int32)
    count = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    slot = torch.gather(count, 0, owner[None, :].long())[0] - 1
    return owner, slot


def gather_global(
    x: torch.Tensor,  # [v_max, ...] per-shard field block
    idx: torch.Tensor,  # i32[K] global vertex ids (may include the sentinel N)
    starts: torch.Tensor,  # i32[S+1] owner map (every shard's copy)
    n_vertices: int,
    v_max: int,
    fill=None,
    group=None,
    dedup: bool = True,
) -> torch.Tensor:
    """Dynamic read of ``field[idx]`` across shards (request/reply).

    As the JAX function: with ``fill=None`` out-of-range ids clip (read
    vertex ``N-1``); otherwise, across shards, every id outside ``[0, N)``
    reads ``fill`` (a single shard reads through :func:`gops.gather`,
    whose fill mode wraps ``[-N, -1]``). Two ``all_to_all`` rounds,
    ``2·S·K`` values of traffic per shard.

    ``dedup=True`` (default) combines duplicate requests before bucketing
    — one request slot and one reply per *distinct* target id; replies fan
    back out through the inverse permutation. The sorted distinct ids are
    padded to ``K`` with ``n_vertices`` (``jnp.unique(..., size=K,
    fill_value=N)``), so the exchange shapes stay those of the raw request
    set and every duplicate collapses to the padding sentinel.
    """
    (k,) = idx.shape
    n_shards = starts.shape[0] - 1
    if n_shards == 1:
        return gops.gather(x, torch.where(idx >= n_vertices, v_max, idx), fill)
    if dedup and k > 1:
        uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
        pad = idx.new_full((k - uniq.shape[0],), n_vertices)
        vals = gather_global(
            x, torch.cat([uniq, pad]), starts, n_vertices, v_max,
            fill=fill, group=group, dedup=False,
        )
        return gops.gather(vals, inv.to(torch.int32))
    idxc = torch.clamp(idx, 0, n_vertices - 1)
    owner, slot = _owner_and_slot(idxc, starts, n_shards)
    local = idxc - gops.gather(starts, owner)
    pos = owner * k + slot  # flat [owner, slot]: every pair distinct
    req = torch.full((n_shards * k,), v_max, dtype=torch.int32, device=idx.device)
    req = gops.scatter_set(req, pos, local).reshape(n_shards, k)
    req_t = _all_to_all(req, group)
    vals = gops.gather(x, req_t)  # [S, K, ...]; padded slots clip, unread
    vals_t = _all_to_all(vals, group)
    out = gops.gather(vals_t.reshape((n_shards * k,) + x.shape[1:]), pos)
    if fill is not None:
        oob = torch.logical_or(idx < 0, idx >= n_vertices)
        oshape = oob.shape + (1,) * (out.ndim - oob.ndim)
        fv = gather_kernel._fill_value(fill, x.dtype).to(x.device)
        out = torch.where(oob.reshape(oshape), fv, out)
    return out


def scatter_reduce(
    idx: torch.Tensor,  # i32[K] global target ids
    values: torch.Tensor,  # [K, ...] message payloads
    op: str,
    starts: torch.Tensor,  # i32[S+1]
    n_vertices: int,
    v_max: int,
    mask: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Combine remote-write messages onto their owners → ``[v_max, ...]``.

    Returns each shard's *delta*: the combiner-fold of every message
    targeting its owned rows, identity where no message arrived. The caller
    folds the delta into the live field (receiver-side masking stays local
    to the owner). Out-of-range / masked targets go to the drop slot
    ``S·v_max``, matching ``scatter_combine``'s ``mode="drop"``. Int sums
    are exact; a float sum adds the shards' deltas in the collective's
    order.
    """
    n_shards = starts.shape[0] - 1
    bool_io = values.dtype == torch.bool
    if bool_io:  # or/and combine via int min/max, as repro_torch.graph.ops does
        values = values.to(torch.int32)
        op_eff = {"or": "max", "and": "min"}.get(op, op)
    else:
        op_eff = op
    ident = gops._identity_for(op_eff, values.dtype)
    padded = torch.full(
        (n_shards * v_max,) + values.shape[1:], ident,
        dtype=values.dtype, device=values.device,
    )
    idxc = torch.clamp(idx, 0, n_vertices - 1)
    owner = _owner_of(idxc, starts, n_shards)
    pos = owner * v_max + (idxc - gops.gather(starts, owner))
    oob = torch.logical_or(idx < 0, idx >= n_vertices)
    if mask is not None:
        oob = torch.logical_or(oob, ~mask)
    pos = torch.where(oob, n_shards * v_max, pos)  # out-of-range ⇒ dropped
    padded = gops.scatter_combine(padded, pos, values, op_eff)
    if n_shards == 1:
        out = padded
    elif op_eff == "sum":
        out = padded.new_empty((v_max,) + padded.shape[1:])
        dist.reduce_scatter_tensor(out, padded, group=group)
    else:
        blocks = padded.reshape((n_shards, v_max) + padded.shape[1:])
        recv = _all_to_all(blocks, group)
        out = gops.combine_along_axis(op_eff, recv, axis=0)
    if bool_io:
        if op == "or":
            return torch.clamp(out, min=0) > 0
        if op == "and":
            return torch.clamp(out, max=1) > 0
        return out.to(torch.bool)
    return out
