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
plain versions read the ids. The JAX package's sharding hints (``_ce``,
``constrain``) do nothing without a mesh and are dropped;
``pna_layer_fused`` / ``mpnn_layer_fused`` fall back to :func:`pna_layer` /
:func:`mpnn_layer` on one device and come with the mesh (ROADMAP A8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.graph import ops as gops
from repro_torch.models.common import dense_init


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
    nbr_vals = gops.mp_gather(x, src)
    if aggregator == "mean":
        agg = _mean(nbr_vals, dst, n, emask, offsets)
    else:
        agg = gops.mp_segment_reduce(nbr_vals, dst, n, aggregator, mask=emask,
                                     offsets=offsets)
        if aggregator in ("min", "max"):
            agg = torch.where(torch.isfinite(agg), agg, 0.0)
    return F.relu(x @ p["w_self"] + agg @ p["w_nbr"] + p["b"])


def init_gat_layer(gen, d_in, d_out, n_heads, dtype):
    w = dense_init(gen, d_in, n_heads * d_out, dtype)
    a = [
        (torch.randn((n_heads, d_out), generator=gen, device=gen.device) * 0.1).to(dtype)
        for _ in range(2)
    ]
    return {"w": w, "a_src": a[0], "a_dst": a[1]}


def gat_layer(p, x, src, dst, emask, n, n_heads, d_out, concat=True, offsets=None):
    h = (x @ p["w"]).reshape(n, n_heads, d_out)
    alpha_src = torch.einsum("nhd,hd->nh", h, p["a_src"])
    alpha_dst = torch.einsum("nhd,hd->nh", h, p["a_dst"])
    scores = F.leaky_relu(
        gops.mp_gather(alpha_src, src) + gops.mp_gather(alpha_dst, dst),
        negative_slope=0.2,
    )  # [E, H]
    att = gops.mp_edge_softmax(scores, dst, n, mask=emask, offsets=offsets)
    del scores
    vals = gops.mp_gather(h, src)  # [E, H, D]
    if vals.requires_grad or att.requires_grad:  # the product's backward reads both
        vals = vals * att[..., None]
    else:  # serving: no second [E, H, D] buffer
        vals.mul_(att[..., None])
    del att
    out = gops.mp_segment_reduce(vals, dst, n, "sum", mask=emask,
                                 offsets=offsets)  # [N, H, D]
    if concat:
        return F.elu(out.reshape(n, n_heads * d_out))
    return F.elu(out.mean(dim=1))


def init_pna_layer(gen, d_in, d_out, n_agg, n_scale, dtype):
    return {
        "w": dense_init(gen, d_in * (1 + n_agg * n_scale), d_out, dtype),
        "b": torch.zeros((d_out,), dtype=dtype, device=gen.device),
        "w_pre": dense_init(gen, d_in, d_in, dtype),
    }


def pna_layer(p, x, src, dst, emask, n, aggregators, scalers, delta, offsets=None):
    msg = F.relu(gops.mp_gather(x, src) @ p["w_pre"])
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
    logd = torch.log1p(deg)[:, None, None]
    outs = []
    for s in scalers:
        if s == "identity":
            outs.append(agg)
        elif s == "amplification":
            outs.append(agg * (logd / delta))
        elif s == "attenuation":
            outs.append(agg * (delta / torch.clamp(logd, min=1e-3)))
    feats = torch.cat([x] + [o.reshape(n, -1) for o in outs], dim=-1)
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
    cat = torch.cat(
        [gops.mp_gather(x, src), gops.mp_gather(x, dst), e_feat], dim=-1
    )
    e_new = F.silu(cat @ p["edge_w1"]) @ p["edge_w2"] + e_feat
    del cat
    agg = gops.mp_segment_reduce(e_new, dst, n, "sum", mask=emask, offsets=offsets)
    x_new = F.silu(torch.cat([x, agg], dim=-1) @ p["node_w1"]) @ p["node_w2"] + x
    return x_new, e_new
