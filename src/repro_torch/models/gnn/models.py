"""GNN models: init, forward and loss for the four assigned architectures.

The JAX package's ``repro.models.gnn.models`` on torch tensors, with the
dry-run's ``abstract_params`` / ``input_specs`` (fake tensors). ``forward``,
``loss_fn`` (every task branch) and ``sage_minibatch_loss`` carry
gradients through ``graph.ops`` (``kernels.autograd``) wherever the
parameters require them; serving calls them with frozen parameters or
under ``torch.no_grad()``.

Batch contract (full-graph modes), as in JAX:
    {"x": [N, Din], "src": [E], "dst": [E], "emask": [E],
     "labels": [N] or [N, n_out], "lmask": [N]}
with ``dst`` ascending (the graph's pull ordering) and padding edges
``src = dst = N``, ``emask = False``. Sampled minibatch (``minibatch_lg``):
    {"seed_x": [B, Din], "hop0_x": [B*f0, Din], "hop0_mask": [B, f0],
     "hop1_x": [B*f0*f1, Din], "hop1_mask": [B*f0, f1], "labels": [B]}

:func:`forward` checks once per batch that ``dst`` is ascending and
computes its segment offsets (``graph.structure.segment_offsets``); every
layer reuses them, and the padding rows lie past the last offset. On the
card unsorted ``dst`` raises, as ``graph.ops.segment_reduce`` does; the
CPU's plain versions read the ids and need no order. The layer stacks that
JAX runs under ``lax.scan`` (PNA's tail, GraphCast's processor) keep their
stacked leading dimension here and run as a Python loop over it, each
layer checkpointed (``torch.utils.checkpoint``) under ``cfg.remat`` when a
gradient is wanted, as JAX's ``jax.checkpoint``; ``optimization_barrier``
has no counterpart (``models.common``).

On a multi-rank mesh (``dist.sharding.activate``) a graph's node and edge
rows are split over every rank, as JAX's ``batch_shardings("gnn")`` and
its ``constrain(t, (ALL, ...))`` lay them out: rank ``r`` holds rows
``[r·N/n, (r+1)·N/n)`` of every node tensor and ``[r·E/n, (r+1)·E/n)`` of
every edge tensor (flat DTensors, ``dist.sharding``), from the batch's
leaves through every activation between layers to the output; a dimension
the mesh does not divide stays whole on every rank, as JAX's ``_maybe``
leaves it. The batch may come split so (``launch.train.data_parallel``)
or whole (then each rank takes its rows: a view, no collective). A rank
gathers node state whole only at a region's entry (``graph.ops``), as
JAX's ``shard_map`` does, and drops it after the region. PNA and GraphCast
run their fused layers (one region a layer); SAGE and GAT reach the mesh
through the ``mp_*`` ops. The parameters are whole on every rank and enter
each rank's share of the work through ``copy_in``, so their gradients are
the sums over the ranks: every rank holds the whole gradient. The output
is this rank's rows of ``[N, n_out]``; :func:`loss_fn` sums the ranks'
shares into JAX's global loss, equal on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import ALL, constrain, rowwise
from repro_torch.graph import ops as gops
from repro_torch.graph.structure import resolve_device, segment_offsets
from repro_torch.kernels import fake
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.models.gnn import layers as L
from repro_torch.models.gnn.config import GNNConfig


# ---------------------------------------------------------------------------
# init


def init(cfg: GNNConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` on ``device``, in the JAX
    tree's layout, shapes and dtypes: the JAX initialisers' distributions
    (dense layers N(0, 1/d_in), GAT attention vectors N(0, 0.01), biases
    0), not their bits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    p: Dict[str, Any] = {"layers": []}
    d = cfg.d_hidden
    if cfg.variant == "sage":
        dims = [cfg.d_in] + [d] * cfg.n_layers
        p["layers"] = [
            L.init_sage_layer(gen, dims[i], dims[i + 1], dtype)
            for i in range(cfg.n_layers)
        ]
    elif cfg.variant == "gat":
        dims = [cfg.d_in] + [d * cfg.n_heads] * cfg.n_layers
        p["layers"] = [
            L.init_gat_layer(gen, dims[i], d, cfg.n_heads, dtype)
            for i in range(cfg.n_layers)
        ]
    elif cfg.variant == "pna":
        na, nsc = len(cfg.pna_aggregators), len(cfg.pna_scalers)
        # first layer maps d_in -> d; the uniform tail is stacked
        p["layer0"] = L.init_pna_layer(gen, cfg.d_in, d, na, nsc, dtype)
        if cfg.n_layers > 1:
            p["layers"] = common.stack_init(
                cfg.n_layers - 1, lambda: L.init_pna_layer(gen, d, d, na, nsc, dtype)
            )
        else:
            p["layers"] = None
    elif cfg.variant == "graphcast":
        de = max(cfg.d_edge, d)
        p["encode_node"] = dense_init(gen, cfg.d_in, d, dtype)
        p["encode_edge"] = dense_init(gen, 1, de, dtype)  # from edge weight
        p["layers"] = common.stack_init(
            cfg.n_layers, lambda: L.init_mpnn_layer(gen, d, de, dtype)
        )
    else:
        raise ValueError(cfg.variant)
    d_final = d * cfg.n_heads if cfg.variant == "gat" else d
    p["head"] = dense_init(gen, d_final, cfg.n_out, dtype)
    return p


def params_from_arrays(cfg: GNNConfig, tree: Mapping[str, Any], device="cuda",
                       trainable: bool = False):
    """The JAX package's parameter tree (each leaf a numpy array) on
    ``device``, in the same nesting; stacked layers keep their leading
    layer dimension, and PNA's ``layers`` of a one-layer config stays
    ``None``. ``trainable`` makes every float leaf require gradients."""
    tree = common.tensors_from_arrays(tree, resolve_device(device))
    return common.trainable(tree) if trainable else tree


def abstract_params(cfg: GNNConfig, device="cuda") -> Dict[str, Any]:
    """:func:`init`'s parameters as fake tensors on ``device``
    (``models.common.abstract_like``): shapes and dtypes, nothing allocated."""
    return common.abstract_like(init, cfg, device=device)


def _cast(params, dtype):
    """Every float32 leaf cast to the compute dtype (else bf16 activations
    would promote back to f32), as the JAX forward casts."""
    if params is None:
        return None
    if isinstance(params, Mapping):
        return {k: _cast(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.dtype == torch.float32 else params


def _layer(stacked: Mapping[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of a stacked layer tree (one step of JAX's ``lax.scan``)."""
    return {k: v[i] for k, v in stacked.items()}


def dst_offsets(dst: torch.Tensor, n: int) -> Optional[torch.Tensor]:
    """The segment offsets ``i32[n + 1]`` of a batch's ``dst``, after one
    check that it is ascending. Unsorted ids raise on the card; on the CPU
    they give ``None`` (the plain versions read the ids). The dry-run's
    fake ids have no values to check: its batches are the pipeline's, in
    the graph's pull ordering (``input_specs``), so they count as ascending.
    Of a flat DTensor (a rank's rows of the batch) the offsets of this
    rank's rows, into the global rows: each shifted by the index of the
    rank's first row (``graph.ops.EdgeRegion.offsets`` reads either kind)."""
    if shd.is_flat(dst):
        off = dst_offsets(dst.to_local(), n)
        return None if off is None else off + shd.row_start(dst)
    if fake.is_fake(dst):
        return segment_offsets(dst.to(torch.int32), n)
    ascending = bool((dst[1:] >= dst[:-1]).all()) if dst.numel() > 1 else True
    if not ascending:
        if dst.device.type == "cuda":
            raise ValueError(
                "GNN forward on the card needs the batch's dst ascending "
                "(the graph's pull ordering)"
            )
        return None
    return segment_offsets(dst.to(torch.int32), n)


# ---------------------------------------------------------------------------
# full-graph forward


def _ckpt(cfg: GNNConfig, fn):
    """``fn`` checkpointed under ``cfg.remat`` while gradients are on."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _rows_mm(x, w):
    """``x @ w`` whose every row rounds alike whatever the number of rows.
    On the card a bf16 or f16 product with a dimension that is not a
    multiple of 8 (GraphCast's 1,433-wide cora features, its 227 outputs)
    takes a kernel that cuBLAS picks by the row count (split-K, partial
    sums in the half type): a rank's block of rows rounds otherwise than
    the whole (``chip_smoke.py --row-gemm`` measures it), and GraphCast's
    sixteen layers grow such a difference past any elementwise bound.
    With the contraction and the output zero-padded to multiples of 8 the
    product takes the aligned kernels, whose rows round alike for any row
    count. Elsewhere ``x @ w``."""
    k, n = w.shape
    if (k % 8 == 0 and n % 8 == 0) or x.dtype not in (torch.bfloat16, torch.float16) \
            or not fake.on_card(x):
        return x @ w
    pad_k, pad_n = -k % 8, -n % 8
    return (F.pad(x, (0, pad_k)) @ F.pad(w, (0, pad_n, 0, pad_k)))[..., :n]


def _head(h, w):
    """The output layer ``f32[N, n_out]`` on this rank's rows."""
    return rowwise(lambda h, w: _rows_mm(h, w).float(), (h,), w)


def forward(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """Node outputs ``f32[N, n_out]`` of a full-graph batch (on a multi-rank
    mesh this rank's rows of them, a flat DTensor, where the mesh divides
    ``N``)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = batch["x"].to(cdt)
    src, dst, emask = batch["src"], batch["dst"], batch["emask"]
    n = x.shape[0]
    off = dst_offsets(dst, n)

    def _c(t):  # shard node/edge activations over every mesh axis
        return constrain(t, (ALL,) + (None,) * (t.ndim - 1))

    x = _c(x)
    if cfg.variant == "graphcast":
        cp = _cast(params, cdt)
        h = _c(rowwise(lambda x, w: F.silu(_rows_mm(x, w)), (x,), cp["encode_node"]))
        w = batch.get("ew")
        w = torch.ones_like(src, dtype=cdt) if w is None else w.to(cdt)
        e = _c(rowwise(lambda w, we: F.silu(_rows_mm(w[:, None], we)), (_c(w),),
                       cp["encode_edge"]))  # [E, De]

        def gc_body(lp, h, e):
            h, e = L.mpnn_layer_fused(lp, h, e, src, dst, emask, n, offsets=off)
            return _c(h), _c(e)

        for i in range(cp["layers"]["edge_w1"].shape[0]):
            h, e = _ckpt(cfg, gc_body)(_layer(cp["layers"], i), h, e)
        return _head(h, cp["head"])

    if cfg.variant == "pna":
        cp = _cast(params, cdt)

        def pna_apply(lp, h):
            return _c(L.pna_layer_fused(lp, h, src, dst, emask, n, cfg.pna_aggregators,
                                        cfg.pna_scalers, cfg.pna_delta, offsets=off))

        h = _ckpt(cfg, pna_apply)(cp["layer0"], x)
        if cp.get("layers") is not None:
            for i in range(cp["layers"]["w"].shape[0]):
                h = _ckpt(cfg, pna_apply)(_layer(cp["layers"], i), h)
        return _head(h, cp["head"])

    def one_layer(lp, h):
        if cfg.variant == "sage":
            h = L.sage_layer(lp, h, src, dst, emask, n, cfg.aggregator, offsets=off)
        else:
            h = L.gat_layer(lp, h, src, dst, emask, n, cfg.n_heads, cfg.d_hidden,
                            offsets=off)
        return _c(h)

    h = x
    for lp in params["layers"]:
        h = _ckpt(cfg, one_layer)(lp, h)
    return _head(h, params["head"])


def _mine(t: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A node-level batch leaf as the rows of ``out`` this rank holds: a
    flat DTensor's local rows, a whole leaf cut to the rows of a flat
    ``out``; else the leaf itself."""
    if shd.is_flat(t):
        return t.to_local()
    if shd.is_flat(out):
        start = shd.row_start(out)
        return t[start:start + out.to_local().shape[0]]
    return t


def loss_fn(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """The JAX ``loss_fn``'s task branches: regression (masked MSE, or per
    graph over ``graph_id`` pooling), graph classification (mean-pooled
    cross-entropy) and node classification (masked cross-entropy). The
    per-graph pools are segment sums over the ascending ``graph_id``. On a
    mesh whose ranks each hold their node rows the sums over nodes — the
    masked sums and their denominators, the per-graph pools and counts —
    are each rank's rows' sums psummed over the ranks (a graph's nodes may
    straddle ranks), so every rank computes JAX's global loss; a
    graph-level ``labels`` split over the ranks is gathered whole."""
    out = forward(params, batch, cfg)
    group = out.device_mesh.get_group() if shd.is_flat(out) else None
    local = shd.local_rows(out)

    def mine(key):
        return _mine(batch[key], out)

    def total(t):
        s = t.sum()
        return s if group is None else coll.psum(s, group)

    if cfg.task == "regression":
        if "graph_id" in batch:
            labels = shd.whole(batch["labels"])
            pred = _graph_mean(local, mine("graph_id"), labels.shape[0], group)
            return (pred - labels).float().square().mean()
        err = (local - mine("labels")).float()
        m = batch.get("lmask")
        if m is not None:
            m = mine("lmask")
            err = err * m[:, None]
            denom = torch.clamp(total(m), min=1.0) * out.shape[-1]
            return total(err.square()) / denom
        if group is None:
            return err.square().mean()
        return total(err.square()) / out.numel()
    if cfg.task == "graph_class":
        labels = shd.whole(batch["labels"])
        logits = _graph_mean(local, mine("graph_id"), labels.shape[0], group)
        return common.softmax_cross_entropy(logits, labels)
    # node classification with a labeled-node mask
    logits = local.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, mine("labels").long()[:, None])[:, 0]
    per_node = lse - gold
    if batch.get("lmask") is not None:
        m = mine("lmask")
        return total(per_node * m) / torch.clamp(total(m), min=1.0)
    if group is None:
        return per_node.mean()
    return total(per_node) / out.shape[0]


def _graph_mean(out, graph_id, n_graphs, group=None):
    """Mean of ``out``'s rows per graph (disjoint-union batching); with
    ``group`` the ranks' partial pools and counts of their rows summed."""
    off = dst_offsets(graph_id, n_graphs)
    pooled = gops.segment_reduce(out, graph_id, n_graphs, "sum", offsets=off)
    ones = torch.ones(out.shape[:1], dtype=out.dtype, device=out.device)
    cnt = gops.segment_reduce(ones, graph_id, n_graphs, "sum", offsets=off)
    if group is not None:
        pooled, cnt = coll.psum(pooled, group), coll.psum(cnt, group)
    return pooled / torch.clamp(cnt[:, None], min=1.0)


# ---------------------------------------------------------------------------
# sampled-minibatch SAGE (GraphSAGE's native mode)


def sage_minibatch_forward(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """Two-hop sampled forward with padded blocks (fanouts f0, f1)."""
    assert cfg.variant == "sage" and len(cfg.fanouts) == 2
    f0, f1 = cfg.fanouts
    seed_x = batch["seed_x"]  # [B, Din]
    hop0_x = batch["hop0_x"]  # [B*f0, Din]
    hop1_x = batch["hop1_x"]  # [B*f0*f1, Din]
    m0 = batch["hop0_mask"]  # [B, f0]
    m1 = batch["hop1_mask"]  # [B*f0, f1]
    b = seed_x.shape[0]
    l1, l2 = params["layers"]

    def masked_mean(vals, mask):
        w = mask[..., None].to(vals.dtype)
        return (vals * w).sum(dim=-2) / torch.clamp(w.sum(dim=-2), min=1.0)

    # layer 1 at hop-0 nodes: aggregate their sampled hop-1 neighbors
    nbr1 = masked_mean(hop1_x.reshape(b * f0, f1, -1), m1)
    h0 = F.relu(hop0_x @ l1["w_self"] + nbr1 @ l1["w_nbr"] + l1["b"])
    # layer 1 at seeds (self transform with their own neighbors = hop0 raw)
    nbr_seed = masked_mean(hop0_x.reshape(b, f0, -1), m0)
    h_seed = F.relu(seed_x @ l1["w_self"] + nbr_seed @ l1["w_nbr"] + l1["b"])
    # layer 2 at seeds: aggregate hop-0 hidden states
    nbr2 = masked_mean(h0.reshape(b, f0, -1), m0)
    h = F.relu(h_seed @ l2["w_self"] + nbr2 @ l2["w_nbr"] + l2["b"])
    return h @ params["head"]


def sage_minibatch_loss(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """Cross-entropy of the sampled two-hop forward at the seeds."""
    logits = sage_minibatch_forward(params, batch, cfg)
    return common.softmax_cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# dry-run input specs


def input_specs(cfg: GNNConfig, shape_kind: str, device="cuda", **dims) -> Dict[str, Any]:
    """Fake tensors of a batch (the JAX package's ``input_specs``, its keys,
    shapes and dtypes), which are also what ``data.pipeline`` yields:
    ``full_graph`` {x f32 [N, d], src/dst i32 [E], emask bool [E], labels
    (i32 [N], or f32 [N, n_out] for regression), lmask f32 [N]};
    ``minibatch`` the sampled blocks of ``gnn_minibatches``;
    ``batched_graphs`` B graphs as one with ``graph_id`` i32 [B·N]. A fake
    ``dst`` (and ``graph_id``) has no values: the forward takes it as
    ascending, the pipeline's pull ordering (:func:`dst_offsets`)."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def spec(shape, dtype):
        return common.fake_tensor(shape, dtype, device)

    d = dims.get("d_feat", cfg.d_in)
    if shape_kind == "full_graph":
        n, e = dims["n_nodes"], dims["n_edges"]
        out = {"x": spec((n, d), f32), "src": spec((e,), i32), "dst": spec((e,), i32),
               "emask": spec((e,), b8)}
        out["labels"] = (spec((n, cfg.n_out), f32) if cfg.task == "regression"
                         else spec((n,), i32))
        out["lmask"] = spec((n,), f32)
        return out
    if shape_kind == "minibatch":
        b = dims["batch_nodes"]
        f0, f1 = cfg.fanouts
        return {
            "seed_x": spec((b, d), f32),
            "hop0_x": spec((b * f0, d), f32),
            "hop0_mask": spec((b, f0), b8),
            "hop1_x": spec((b * f0 * f1, d), f32),
            "hop1_mask": spec((b * f0, f1), b8),
            "labels": spec((b,), i32),
        }
    if shape_kind == "batched_graphs":
        b, n, e = dims["batch"], dims["n_nodes"], dims["n_edges"]
        return {
            "x": spec((b * n, d), f32),
            "src": spec((b * e,), i32),
            "dst": spec((b * e,), i32),
            "emask": spec((b * e,), b8),
            "graph_id": spec((b * n,), i32),
            "labels": (spec((b, cfg.n_out), f32) if cfg.task == "regression"
                       else spec((b,), i32)),
        }
    raise ValueError(shape_kind)
