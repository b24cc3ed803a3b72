"""GNN layers on the shared segment-op substrate (``repro_torch.graph.ops``).

The JAX package's ``repro.models.gnn.layers`` on torch tensors. Every layer is "one algorithmic superstep" in the paper's model:
gather neighbor state along edges, segment-reduce by destination, update
locally; every layer differentiates through ``graph.ops``. On the card
the gathers of node rows run ``kernels.gather_rows``
(its ``scalar`` route: rows of D features) and the reductions run
``kernels.segment_reduce`` (its ``cols`` route for ``[E, D]`` values, its
``rows`` route for the ``[E]`` degree counts), the same kernels as the
Palgol main path.

Each layer takes the ``offsets`` of its ascending ``dst`` (the model's
``forward`` computes them once per batch); the card needs them, the CPU's
plain versions read the ids. On a multi-rank mesh node state and a
batch's edges are split over every rank as JAX lays them out (flat
DTensors, ``dist.sharding``; whole where the mesh does not divide them).
The ``mp_*`` calls run each rank's edge rows against the node state
gathered whole at the region's entry (``graph.ops``); their edge results
are flat DTensors, so the elementwise work between them runs on each
rank's rows, as does a product of one with a weight (:func:`_mm`). A
reduction returns the whole ``[N, ...]`` (JAX's psum), of which each rank
keeps its rows (:func:`_ce`) for the dense node update on them
(``dist.sharding.rowwise``: the parameters enter through ``copy_in``).
:func:`pna_layer_fused` and :func:`mpnn_layer_fused` run a whole layer's
edge work in one region — the node state gathered whole once a layer,
the sums reduce-scattered to node shards, the node update on this rank's
rows, which they return (JAX's ``out_specs`` ``P(d, None)``) — and fall
back to :func:`pna_layer` / :func:`mpnn_layer` off-mesh or when the mesh
does not divide the edges, as the JAX functions do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import ALL, constrain, rowwise
from repro_torch.graph import ops as gops
from repro_torch.models.common import dense_init


def _ce(t):
    """Shard a node- or edge-indexed tensor over every mesh axis."""
    return constrain(t, (ALL,) + (None,) * (t.ndim - 1))


def _mm(rows, w):
    """``rows @ w`` on this rank's rows (the weight enters the region)."""
    return rowwise(torch.matmul, (rows,), w)


def _mean(vals, dst, n, mask, offsets=None, cnt=None):
    """Masked mean of edge rows per destination (``cnt``, the masked in-degree
    in ``vals``' dtype, is summed here unless given)."""
    s = gops.mp_segment_reduce(vals, dst, n, "sum", mask=mask, offsets=offsets)
    if cnt is None:
        cnt = _count(vals, dst, n, mask, offsets)
    return s / torch.clamp(cnt[:, None], min=1.0)


def _count(vals, dst, n, mask, offsets):
    """The masked in-degree as a sum of ones in ``vals``' dtype."""
    ones = torch.ones(vals.shape[:1], dtype=vals.dtype, device=vals.device)
    return gops.mp_segment_reduce(ones, dst, n, "sum", mask=mask, offsets=offsets)


def init_sage_layer(gen, d_in, d_out, dtype):
    return {
        "w_self": dense_init(gen, d_in, d_out, dtype),
        "w_nbr": dense_init(gen, d_in, d_out, dtype),
        "b": torch.zeros((d_out,), dtype=dtype, device=gen.device),
    }


def sage_layer(p, x, src, dst, emask, n, aggregator="mean", offsets=None):
    nbr_vals = _ce(gops.mp_gather(x, src))
    if aggregator == "mean":
        agg = _mean(nbr_vals, dst, n, emask, offsets)
    else:
        agg = gops.mp_segment_reduce(nbr_vals, dst, n, aggregator, mask=emask,
                                     offsets=offsets)
        if aggregator in ("min", "max"):
            agg = torch.where(torch.isfinite(agg), agg, 0.0)
    return rowwise(_sage_update, (_ce(x), _ce(agg)), p)


def _sage_update(x, agg, p):
    return F.relu(x @ p["w_self"] + agg @ p["w_nbr"] + p["b"])


def init_gat_layer(gen, d_in, d_out, n_heads, dtype):
    w = dense_init(gen, d_in, n_heads * d_out, dtype)
    a = [
        (torch.randn((n_heads, d_out), generator=gen, device=gen.device) * 0.1).to(dtype)
        for _ in range(2)
    ]
    return {"w": w, "a_src": a[0], "a_dst": a[1]}


def gat_layer(p, x, src, dst, emask, n, n_heads, d_out, concat=True, offsets=None):
    h, alpha_src, alpha_dst = rowwise(
        lambda x, p: _gat_project(x, p, n_heads, d_out), (_ce(x),), p)
    scores = _ce(F.leaky_relu(
        gops.mp_gather(alpha_src, src) + gops.mp_gather(alpha_dst, dst),
        negative_slope=0.2,
    ))  # [E, H]
    del alpha_src, alpha_dst
    att = _ce(gops.mp_edge_softmax(scores, dst, n, mask=emask, offsets=offsets))
    del scores
    vals = _ce(gops.mp_gather(h, src))  # [E, H, D]
    if vals.requires_grad or att.requires_grad:  # the product's backward reads both
        vals = vals * att[..., None]
    else:  # serving: no second [E, H, D] buffer
        vals.mul_(att[..., None])
    del att
    out = _ce(gops.mp_segment_reduce(vals, dst, n, "sum", mask=emask,
                                     offsets=offsets))  # [N, H, D]
    if concat:
        return rowwise(lambda o: F.elu(o.reshape(o.shape[0], n_heads * d_out)), (out,))
    return rowwise(lambda o: F.elu(o.mean(dim=1)), (out,))


def _gat_project(x, p, n_heads, d_out):
    """The heads' features ``[n, H, D]`` and their source and destination
    attention logits ``[n, H]``."""
    h = (x @ p["w"]).reshape(x.shape[0], n_heads, d_out)
    alpha_src = torch.einsum("nhd,hd->nh", h, p["a_src"])
    alpha_dst = torch.einsum("nhd,hd->nh", h, p["a_dst"])
    return h, alpha_src, alpha_dst


def init_pna_layer(gen, d_in, d_out, n_agg, n_scale, dtype):
    return {
        "w": dense_init(gen, d_in * (1 + n_agg * n_scale), d_out, dtype),
        "b": torch.zeros((d_out,), dtype=dtype, device=gen.device),
        "w_pre": dense_init(gen, d_in, d_in, dtype),
    }


def pna_layer(p, x, src, dst, emask, n, aggregators, scalers, delta, offsets=None):
    nbr = gops.mp_gather(x, src)
    msg = _ce(F.relu(_mm(nbr, p["w_pre"])))
    del nbr
    # the in-degree of every aggregator and scaler: one sum of ones in the
    # compute dtype, as the JAX layer's (which sums it once for ``deg`` and
    # once in each ``_mean``, to the same value)
    deg = _count(msg, dst, n, emask, offsets)
    aggs = []
    mean = _mean(msg, dst, n, emask, offsets, cnt=deg)
    for a in aggregators:
        if a == "mean":
            aggs.append(mean)
        elif a == "std":
            sq = _mean(msg.square(), dst, n, emask, offsets, cnt=deg)
            aggs.append(torch.sqrt(torch.clamp(sq - mean.square(), min=0.0) + 1e-5))
        else:
            v = gops.mp_segment_reduce(msg, dst, n, a, mask=emask, offsets=offsets)
            aggs.append(torch.where(torch.isfinite(v), v, 0.0))
    del msg
    agg = torch.stack(aggs, dim=1)  # [N, A, D]
    return rowwise(lambda x, agg, deg, p: _pna_update(x, agg, deg, p, scalers, delta),
                   (_ce(x), _ce(agg), _ce(deg)), p)


def _pna_update(x, agg, deg, p, scalers, delta):
    """The scalers over the aggregates ``agg`` ``[n, A, D]`` of nodes of
    in-degree ``deg``, then the output layer over them and ``x``."""
    logd = torch.log1p(deg)[:, None, None]
    outs = []
    for s in scalers:
        if s == "identity":
            outs.append(agg)
        elif s == "amplification":
            outs.append(agg * (logd / delta))
        elif s == "attenuation":
            outs.append(agg * (delta / torch.clamp(logd, min=1e-3)))
    feats = torch.cat([x] + [o.reshape(x.shape[0], -1) for o in outs], dim=-1)
    return F.relu(feats @ p["w"] + p["b"])


def init_mpnn_layer(gen, d_node, d_edge, dtype):
    """GraphCast-style interaction-network block (edge+node MLPs)."""
    d_cat = 2 * d_node + d_edge
    return {
        "edge_w1": dense_init(gen, d_cat, d_edge, dtype),
        "edge_w2": dense_init(gen, d_edge, d_edge, dtype),
        "node_w1": dense_init(gen, d_node + d_edge, d_node, dtype),
        "node_w2": dense_init(gen, d_node, d_node, dtype),
    }


def mpnn_layer(p, x, e_feat, src, dst, emask, n, offsets=None):
    """x: [N, Dn]; e_feat: [E, De] → (x', e') with residuals (GraphCast)."""
    e_feat = _ce(e_feat)
    cat = _ce(torch.cat(
        [_ce(gops.mp_gather(x, src)), _ce(gops.mp_gather(x, dst)), e_feat], dim=-1
    ))
    e_new = _ce(_mm(F.silu(_mm(cat, p["edge_w1"])), p["edge_w2"]) + e_feat)
    del cat
    agg = gops.mp_segment_reduce(e_new, dst, n, "sum", mask=emask, offsets=offsets)
    return rowwise(_mpnn_node_update, (_ce(x), _ce(agg)), p), e_new


def _mpnn_node_update(x, agg, p):
    return F.silu(torch.cat([x, agg], dim=-1) @ p["node_w1"]) @ p["node_w2"] + x


def _node_rows(region, n):
    """This rank's block of the ``n`` node rows (``psum_scatter(tiled)``'s)."""
    if n % region.n:
        raise ValueError(f"tiled reduce_scatter operand scatter dimension size {n} must "
                         f"be divisible by shard_count {region.n}")
    n_loc = n // region.n
    return slice(region.rank * n_loc, (region.rank + 1) * n_loc)


def _entered(p, keys, group):
    """The parameters ``keys`` of ``p``, each entering the region."""
    return {k: coll.copy_in(p[k], group) for k in keys}


def pna_layer_fused(p, x, src, dst, emask, n, aggregators, scalers, delta, offsets=None):
    """PNA with all aggregations in ONE region: the node state is gathered
    whole once per layer (instead of once per ``mp_*`` call), the
    peak-memory lever on 62M-edge graphs. ``cnt``, ``sum`` and ``sumsq``
    are reduce-scattered to node shards; ``max`` and ``min`` are
    all-reduced (``_diff_pminmax``), then this rank's rows kept — so, as in
    the JAX package, a max's gradient reaches only the ranks that attain it
    among those whose rows hold it. The scalers and the output layer run on
    this rank's node rows, returned as a flat DTensor. Falls back to
    :func:`pna_layer` off-mesh or when the mesh does not divide the edges."""
    region = gops._region(src.shape[0])
    if region is None or src.shape[0] % region.n != 0:
        return pna_layer(p, x, src, dst, emask, n, aggregators, scalers, delta, offsets)
    rows = _node_rows(region, n)
    g = region.group
    x = _ce(x)
    x_full, w_pre = region.nodes(x), coll.copy_in(p["w_pre"], g)
    src_l, dst_l, m_l = region.rows(src, 0), region.rows(dst, n), region.rows(emask, False)
    off_l = region.offsets(offsets)
    msg = F.relu(gops.gather(x_full, src_l) @ w_pre)
    del x_full

    def seg(v, op):
        return gops.segment_reduce(v, dst_l, n, op, mask=m_l, offsets=off_l)

    r = {}
    ones = torch.ones(msg.shape[:1] + (1,), dtype=msg.dtype, device=msg.device)
    r["cnt"] = coll.reduce_scatter_rows(seg(ones, "sum"), g)
    r["sum"] = coll.reduce_scatter_rows(seg(msg, "sum"), g)
    if "std" in aggregators:
        r["sumsq"] = coll.reduce_scatter_rows(seg(msg.square(), "sum"), g)
    for op in ("max", "min"):
        if op in aggregators:
            r[op] = coll.pminmax(seg(msg, op), g, op == "max")[rows]
    del msg
    cnt = torch.clamp(r["cnt"][:, :1], min=1.0)
    mean = r["sum"] / cnt
    aggs = []
    for a in aggregators:
        if a == "mean":
            aggs.append(mean)
        elif a == "std":
            sq = r["sumsq"] / cnt
            aggs.append(torch.sqrt(torch.clamp(sq - mean.square(), min=0.0) + 1e-5))
        elif a in ("max", "min"):
            aggs.append(torch.where(torch.isfinite(r[a]), r[a], 0.0))
    agg = torch.stack(aggs, dim=1)  # [N/n, A, D]
    out = _pna_update(shd.local_rows(x), agg, r["cnt"][:, 0], _entered(p, ("w", "b"), g),
                      scalers, delta)
    return shd.from_rows(out, n, shd.flat_mesh(region.mesh))


def mpnn_layer_fused(p, x, e_feat, src, dst, emask, n, offsets=None):
    """GraphCast block with the gathers, the edge MLP and the aggregation in
    one region: one node-state gather per layer. The aggregate is
    reduce-scattered (no replicated ``[N, D]`` buffer survives it), the
    node MLP runs on this rank's node rows; ``x'`` and ``e'`` come back as
    this rank's rows (flat DTensors). Falls back to :func:`mpnn_layer`
    off-mesh or when the mesh does not divide the edges."""
    region = gops._region(src.shape[0])
    if region is None or src.shape[0] % region.n != 0:
        return mpnn_layer(p, x, e_feat, src, dst, emask, n, offsets)
    _node_rows(region, n)
    g = region.group
    x = _ce(x)
    x_full = region.nodes(x)
    e_loc = region.values(e_feat)
    cat = torch.cat([gops.gather(x_full, region.rows(src, 0)),
                     gops.gather(x_full, region.rows(dst, n)), e_loc], dim=-1)
    del x_full
    e_new = (F.silu(cat @ coll.copy_in(p["edge_w1"], g)) @ coll.copy_in(p["edge_w2"], g)
             + e_loc)
    del cat
    # the partial sums in f32, reduce-scattered in f32 and rounded once, as
    # one rank's segment sum accumulates (JAX psums them in the compute
    # dtype: in bf16 that moved GraphCast's outputs past gnn_serve's rule)
    agg = coll.reduce_scatter_rows(
        gops.segment_reduce(e_new.float(), region.rows(dst, n), n, "sum",
                            mask=region.rows(emask, False), offsets=region.offsets(offsets)),
        g,
    ).to(x.dtype)
    x_new = _mpnn_node_update(shd.local_rows(x), agg,
                              _entered(p, ("node_w1", "node_w2"), g))
    return shd.from_rows(x_new, n, shd.flat_mesh(region.mesh)), region.shard(e_new)
