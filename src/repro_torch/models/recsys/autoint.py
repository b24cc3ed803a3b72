"""AutoInt: self-attentive feature interaction over field embeddings.

The JAX package's ``repro.models.recsys.autoint`` on torch tensors.
Parameters are the JAX tree's nested dicts, with tensors as leaves.
The hot path at serving scale is the embedding lookup (39 fields × 10⁶-row
tables): one ``kernels.embedding_bag`` launch with one-slot bags over the
flat ``[F·V, D]`` table (the CUDA kernel on the card). Interaction is 3
small self-attention layers over the 39 field "tokens", then an MLP head.
``retrieval_score`` scores one query against N candidates as one matmul.
:func:`forward` and :func:`loss_fn` carry gradients where the parameters
require them: the tables' through ``embedding_bag``'s backward
(``kernels.autograd``: a dense ``[F·V, D]`` gradient, as JAX's); the
serving entries run without.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import torch

from repro_torch.graph.structure import resolve_device
from repro_torch.kernels.autograd import embedding_bag
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.models.recsys.config import AutoIntConfig


def init(cfg: AutoIntConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` on ``device``: the JAX
    initialisers' distributions (tables N(0, 0.01²), dense layers
    N(0, 1/d_in), biases 0), not their bits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    d, da = cfg.embed_dim, cfg.d_attn
    tables = torch.randn(
        (cfg.n_fields, cfg.vocab_per_field, d), generator=gen, device=dev
    )
    params: Dict[str, Any] = {"tables": (tables * 0.01).to(dtype)}
    layers = []
    d_in = d
    for _ in range(cfg.n_attn_layers):
        layers.append(
            {name: dense_init(gen, d_in, da, dtype) for name in ("wq", "wk", "wv", "w_res")}
        )
        d_in = da
    params["attn"] = layers
    mlp = []
    din = cfg.n_fields * da
    for dd in cfg.mlp_dims:
        mlp.append({"w": dense_init(gen, din, dd, dtype),
                    "b": torch.zeros(dd, dtype=dtype, device=dev)})
        din = dd
    params["mlp"] = mlp
    params["head"] = dense_init(gen, din, 1, dtype)
    return params


def abstract_params(cfg: AutoIntConfig, device="cuda") -> Dict[str, Any]:
    """:func:`init`'s parameters as fake tensors on ``device``
    (``models.common.abstract_like``): shapes and dtypes, nothing allocated."""
    return common.abstract_like(init, cfg, device=device)


def params_from_arrays(cfg: AutoIntConfig, tree: Mapping[str, Any], device="cuda",
                       trainable: bool = False):
    """The JAX package's parameter tree (each leaf a numpy array) on
    ``device``, in the same nesting; ``trainable`` makes every float leaf
    require gradients."""
    tree = common.tensors_from_arrays(tree, resolve_device(device))
    return common.trainable(tree) if trainable else tree


def _interact(params, emb, cfg: AutoIntConfig):
    """emb: [B, F, D] → interaction representation [B, F, d_attn]."""
    x = emb
    for lp in params["attn"]:
        b, f, _ = x.shape
        q = (x @ lp["wq"]).reshape(b, f, cfg.n_heads, cfg.d_head)
        k = (x @ lp["wk"]).reshape(b, f, cfg.n_heads, cfg.d_head)
        v = (x @ lp["wv"]).reshape(b, f, cfg.n_heads, cfg.d_head)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(cfg.d_head)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, f, -1)
        x = torch.relu(o + x @ lp["w_res"])
    return x


def lookup(params, indices: torch.Tensor) -> torch.Tensor:
    """indices [B, F] int32 → embeddings [B, F, D] from the per-field tables.

    One ``embedding_bag`` launch with one-slot bags over the stacked table
    seen as ``[F·V, D]``: field ``f``'s id ``i`` reads flat row ``f·V + i``,
    clipped to the flat table, so an out-of-range id of field ``f`` reads
    a row of another field — as the JAX package's ``jnp.take(mode="clip")``
    over the same flat table does.
    """
    f, v, d = params["tables"].shape
    flat_tables = params["tables"].reshape(f * v, d)
    offsets = (torch.arange(f, dtype=torch.int32, device=indices.device) * v)[None, :]
    flat_idx = indices.to(torch.int32) + offsets  # [B, F]
    rows = embedding_bag(flat_tables, flat_idx.reshape(-1, 1))
    return rows.reshape(indices.shape + (d,))


def forward(params, batch, cfg: AutoIntConfig):
    """batch: {"fields": [B, F] int32} → logits [B]."""
    emb = lookup(params, batch["fields"])  # [B, F, D]
    x = _interact(params, emb, cfg)
    h = x.reshape(x.shape[0], -1)
    for lp in params["mlp"]:
        h = torch.relu(h @ lp["w"] + lp["b"])
    return (h @ params["head"])[:, 0]


def loss_fn(params, batch, cfg: AutoIntConfig):
    logits = forward(params, batch, cfg)
    return common.sigmoid_bce(logits, batch["labels"])


@torch.no_grad()
def query_embedding(params, batch, cfg: AutoIntConfig):
    """User-side tower for retrieval: pooled interaction output [B, d_attn]."""
    emb = lookup(params, batch["fields"])
    x = _interact(params, emb, cfg)
    return x.mean(dim=1)  # [B, d_attn]


@torch.no_grad()
def retrieval_score(params, batch, cfg: AutoIntConfig, top_k: int = 100):
    """Score one query batch against N candidates: batched dot + top-k.

    batch: {"fields": [B, F], "candidates": [N, d_attn]} → (scores [B, k],
    int32 ids [B, k]).
    """
    q = query_embedding(params, batch, cfg)  # [B, da]
    scores = q @ batch["candidates"].T  # [B, N]
    top = torch.topk(scores, top_k, dim=-1)
    return top.values, top.indices.to(torch.int32)


def input_specs(cfg: AutoIntConfig, kind: str, batch: int, n_candidates: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Fake tensors of a batch (the JAX package's ``input_specs``): int32
    ``fields [B, F]``, for ``train`` f32 ``labels [B]``, for ``retrieval``
    f32 ``candidates [N, d_attn]``."""
    spec = {"fields": common.fake_tensor((batch, cfg.n_fields), torch.int32, device)}
    if kind == "train":
        spec["labels"] = common.fake_tensor((batch,), torch.float32, device)
    if kind == "retrieval":
        spec["candidates"] = common.fake_tensor((n_candidates, cfg.d_attn), torch.float32,
                                                device)
    return spec
