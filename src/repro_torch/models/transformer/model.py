"""Decoder-only LM: init, forward and loss with gradients, prefill and
decode-step.

The JAX package's ``repro.models.transformer.model`` on torch tensors.
Parameters live in a :class:`TransformerParams` module with layer-stacked
tensors (``[L, ...]``, as the JAX tree stacks them for ``lax.scan``); the
layer loop is a Python loop. Prefill attention goes through the
``flash_attention`` kernel (``attention.attention_chunked``); the decode
step's attention over the ring-buffer cache is plain tensor code
(``attention.attention_dense``), as in the JAX package, because the
kernel's implicit positions cannot express the ring.

:func:`decode_step_` is the JAX ``decode_step`` with one change of
contract, which the trailing underscore marks as PyTorch marks its
in-place methods: it writes the new K/V and the advanced length into the
cache's own tensors and returns only the logits. The JAX function returns
a new cache; a copy of the whole ``[L, B, C, Hkv, Dh]`` cache per token is
what the port saves. A caller that needs the cache from before a step
clones it first.

:func:`forward` and :func:`loss_fn` (cross-entropy + 0.01·aux, the JAX
``loss_fn``) are the training entries: with gradients enabled they
differentiate through the flash kernel's backward and the graph kernels'
(``kernels.autograd``), and under ``cfg.remat`` each layer runs under
``torch.utils.checkpoint(use_reentrant=False)``, recomputed in the
backward as JAX's ``jax.checkpoint(layer_fn)``. The layer stack is
``unbind``-ed once per forward, so each stacked weight's gradient is
assembled once. :func:`prefill` and :func:`decode_step_` run without
gradients.

MoE configs (``cfg.moe``) take :mod:`moe`'s FFN in every layer, its
dispatch and combine on the ``gather_rows`` and ``segment_reduce``
kernels; ``forward`` returns the balance loss summed over the layers, as
the JAX ``layer_fn`` carries it, and ``prefill``/``decode_step_`` drop it.

On a multi-rank mesh (``dist.sharding.activate``) every rank holds the
tokens and the activations whole — the JAX module's ``constrain`` calls
sit where its do, and change nothing on a plain tensor — and the MoE FFN
runs expert-parallel (``moe.moe_ffn_ep``): each rank routes its data
shard's tokens to its model shard's experts, and the combine's
collectives hand every rank the whole ``[T, D]``.

The parameters may be held as FSDP shards (:meth:`TransformerParams.
shard_`, the trainer's live state): each sharded leaf is then gathered
whole where it is used (``dist.sharding.Gather``) — a layer's weights
inside the layer's function, so that under remat only one layer's whole
weights are alive and the recompute gathers them again; ``embed`` and
``unembed`` where they are read — and the gathers' backwards hand each
shard its gradient. Whole parameters (one rank, serving) take the same
code with no collective.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import BATCH, constrain
from repro_torch.graph.structure import resolve_device
from repro_torch.models import common
from repro_torch.models.transformer import attention as attn_mod
from repro_torch.models.transformer import moe as moe_mod
from repro_torch.models.transformer.config import TransformerConfig


# ---------------------------------------------------------------------------
# parameters


class TransformerParams(nn.Module):
    """``embed [V, D]``, ``unembed [V, D]`` (``None`` when tied), ``ln_f [D]``
    and ``layers``: the JAX tree's per-layer leaves stacked on axis 0, named
    by their path (``ffn/w1`` → ``ffn_w1``, ``moe/shared/w1`` →
    ``moe_shared_w1``). Frozen (serving) unless ``trainable``."""

    def __init__(self, tensors: Mapping[str, Any], trainable: bool = False):
        super().__init__()
        #: leaf name (as ``named_parameters``) → its ``dist.sharding.Gather``
        #: for a leaf held as this rank's shard (:meth:`shard_`)
        self.gathers: Dict[str, Any] = {}
        param = lambda t: nn.Parameter(t, requires_grad=trainable)  # noqa: E731
        self.embed = param(tensors["embed"])
        self.unembed = param(tensors["unembed"]) if "unembed" in tensors else None
        self.ln_f = param(tensors["ln_f"])
        self.layers = nn.ParameterDict(
            {name: param(t) for name, t in tensors["layers"].items()}
        )

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s parameters, as views of the stacked tensors."""
        return {name: t[i] for name, t in self.layers.items()}

    def map_tensors(self, fn) -> "TransformerParams":
        """A new module holding ``fn`` of each tensor (trainable as this
        one, its leaves gathered as this one's)."""
        tensors = {"embed": fn(self.embed), "ln_f": fn(self.ln_f),
                   "layers": {name: fn(t) for name, t in self.layers.items()}}
        if self.unembed is not None:
            tensors["unembed"] = fn(self.unembed)
        out = TransformerParams(tensors, trainable=self.embed.requires_grad)
        out.gathers = dict(self.gathers)
        return out

    @torch.no_grad()
    def shard_(self, shards: Mapping[str, torch.Tensor], gathers: Mapping[str, Any]):
        """Hold each leaf named in ``shards`` (``named_parameters``' names)
        as that tensor, this rank's slice of it, gathered by ``gathers``'
        entry where it is used; the whole leaf is released."""
        for name, t in shards.items():
            p = nn.Parameter(t, requires_grad=self.embed.requires_grad)
            if name.startswith("layers."):
                self.layers[name[len("layers."):]] = p
            else:
                setattr(self, name, p)
        self.gathers = dict(gathers)

    def whole(self, name: str) -> torch.Tensor:
        """The leaf ``name`` whole (``embed``, ``unembed``, ``ln_f``)."""
        t = getattr(self, name)
        g = self.gathers.get(name)
        return t if g is None else g(t)

    def whole_layer(self, lp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A layer's parameters (:meth:`layer`'s views) with every sharded
        one gathered whole."""
        if not self.gathers:
            return lp
        return {k: t if f"layers.{k}" not in self.gathers else
                self.gathers[f"layers.{k}"](t, lead=1) for k, t in lp.items()}

    def layer_list(self) -> List[Dict[str, torch.Tensor]]:
        """Every layer's parameters from one ``unbind`` of each stacked
        tensor (whose backward stacks the layers' gradients once)."""
        cols = {name: t.unbind(0) for name, t in self.layers.items()}
        return [{name: c[i] for name, c in cols.items()}
                for i in range(len(next(iter(cols.values()))))]


def init_layer(gen: torch.Generator, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    dev, dt = gen.device, cfg.pdtype
    p = {
        "ln1": torch.ones(d, dtype=dt, device=dev),
        "ln2": torch.ones(d, dtype=dt, device=dev),
        "wq": common.dense_init(gen, d, h * hd, dt),
        "wk": common.dense_init(gen, d, hkv * hd, dt),
        "wv": common.dense_init(gen, d, hkv * hd, dt),
        "wo": common.dense_init(gen, h * hd, d, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, dtype=dt, device=dev)
        p["bk"] = torch.zeros(hkv * hd, dtype=dt, device=dev)
        p["bv"] = torch.zeros(hkv * hd, dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dt, device=dev)
        p["k_norm"] = torch.ones(hd, dtype=dt, device=dev)
    if cfg.moe is None:
        p["ffn_w1"] = common.dense_init(gen, d, cfg.d_ff, dt)
        p["ffn_w3"] = common.dense_init(gen, d, cfg.d_ff, dt)
        p["ffn_w2"] = common.dense_init(gen, cfg.d_ff, d, dt)
    else:
        p.update(_flatten(moe_mod.init_moe_params(gen, d, cfg.moe, dt), "moe_"))
    return p


def init(cfg: TransformerConfig, seed: int = 0, device="cuda",
         trainable: bool = False) -> TransformerParams:
    """Random parameters from a ``torch.Generator`` on ``device``: the JAX
    initialisers' distributions (embeddings N(0, 0.02²), dense layers
    N(0, 1/d_in), norms 1, biases 0; :func:`moe.init_moe_params`), not
    their bits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def embedding():
        x = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
        return (x * 0.02).to(cfg.pdtype)

    tensors = {
        "embed": embedding(),
        "layers": common.stack_init(cfg.n_layers, lambda: init_layer(gen, cfg)),
        "ln_f": torch.ones(cfg.d_model, dtype=cfg.pdtype, device=dev),
    }
    if not cfg.tie_embeddings:
        tensors["unembed"] = embedding()
    return TransformerParams(tensors, trainable)


def abstract_params(cfg: TransformerConfig, device="cuda",
                    trainable: bool = False) -> TransformerParams:
    """:func:`init`'s parameters as fake tensors on ``device``
    (``models.common.abstract_like``): shapes and dtypes, nothing allocated."""
    return common.abstract_like(init, cfg, device=device, trainable=trainable)


def _tensor(arr, device) -> torch.Tensor:
    """A numpy array (bfloat16 included, as ``np.asarray`` of a JAX array
    gives it) as a tensor on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out.update(_flatten(leaf, f"{prefix}{name}_"))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


def params_from_arrays(cfg: TransformerConfig, tree: Mapping[str, Any], device="cuda",
                       trainable: bool = False):
    """The JAX package's parameter tree (``init``'s output, each leaf as a
    numpy array) as :class:`TransformerParams` on ``device`` (requiring
    gradients if ``trainable``: a trainer starting from JAX's weights)."""
    dev = resolve_device(device)
    tensors = {
        name: _tensor(tree[name], dev)
        for name in ("embed", "unembed", "ln_f")
        if name in tree
    }
    tensors["layers"] = {
        name: _tensor(arr, dev) for name, arr in _flatten(tree["layers"]).items()
    }
    return TransformerParams(tensors, trainable)


def params_tree(params: TransformerParams) -> Dict[str, Any]:
    """``params`` in the JAX package's nesting (``init``'s tree: ``ffn_w1``
    → ``layers/ffn/w1``, ``moe_shared_w1`` → ``layers/moe/shared/w1``),
    its leaves ``params``' own tensors, not copies: the inverse of
    :func:`params_from_arrays`'s layout, which checkpoints are keyed by."""
    tree: Dict[str, Any] = {"embed": params.embed, "ln_f": params.ln_f}
    if params.unembed is not None:
        tree["unembed"] = params.unembed
    layers: Dict[str, Any] = {}
    for name, t in params.layers.items():
        if name.startswith("ffn_"):
            layers.setdefault("ffn", {})[name[len("ffn_"):]] = t
        elif not name.startswith("moe_"):
            layers[name] = t
    if any(name.startswith("moe_") for name in params.layers):
        layers["moe"] = moe_params(params.layers)
    tree["layers"] = layers
    return tree


# ---------------------------------------------------------------------------
# forward


def project_qkv(p, x, pos, cfg: TransformerConfig):
    """q ``[B, S, H, Dh]`` and k, v ``[B, S, Hkv, Dh]`` of one layer: the
    projections, biases, qk-norm, and RoPE at ``pos`` (k too is rotated
    with the query positions, as in the JAX package)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = constrain(q.reshape(b, s, h, hd), (BATCH, None, "model", None))
    k = constrain(k.reshape(b, s, hkv, hd), (BATCH, None, "model", None))
    v = constrain(v.reshape(b, s, hkv, hd), (BATCH, None, "model", None))
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"])
        k = common.rms_norm(k, p["k_norm"])
    q = attn_mod.apply_rope(q, pos, cfg.rope_theta)
    k = attn_mod.apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _attn_block(p, x, q_pos, k_pos, cfg, k_cache=None, v_cache=None, kv_mask=None):
    """Attention sub-block. With ``k_cache``/``v_cache`` (decode) it attends
    to the cache followed by this call's K/V; returns (out, new_k, new_v)
    where new_k/new_v are this call's K/V."""
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, q_pos, cfg)
    new_k, new_v = k, v
    if k_cache is not None:
        k = torch.cat([k_cache, k], dim=1)
        v = torch.cat([v_cache, v], dim=1)
    out = attn_mod.attention(q, k, v, q_pos, k_pos, cfg, causal=True, kv_mask=kv_mask)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"], new_k, new_v


def moe_params(p) -> Dict[str, Any]:
    """A layer's ``moe_*`` leaves, nested as :func:`moe.init_moe_params`
    names them (``moe_shared_w1`` → ``["shared"]["w1"]``)."""
    out: Dict[str, Any] = {}
    for name, t in p.items():
        if name.startswith("moe_shared_"):
            out.setdefault("shared", {})[name[len("moe_shared_"):]] = t
        elif name.startswith("moe_"):
            out[name[len("moe_"):]] = t
    return out


def _ffn_block(p, x, cfg):
    """The FFN sub-block: (y, aux), aux the MoE balance loss (0.0 dense)."""
    if cfg.moe is None:
        return common.swiglu(x, p["ffn_w1"], p["ffn_w3"], p["ffn_w2"]), 0.0
    b, s, d = x.shape
    y, aux = moe_mod.moe_ffn(x.reshape(b * s, d), moe_params(p), cfg.moe)
    return y.reshape(b, s, d), aux


def _embed(params: TransformerParams, tokens, cfg):
    return params.whole("embed")[tokens.long()].to(cfg.cdtype)


def _layer_fn(lp, x, pos, cfg, whole=None):
    """One layer of the forward: (x after the layer, its MoE aux). ``whole``
    gathers the layer's sharded weights (``TransformerParams.whole_layer``)."""
    if whole is not None:
        lp = whole(lp)
    a, _, _ = _attn_block(lp, common.rms_norm(x, lp["ln1"]), pos, pos, cfg)
    x = constrain(x + a, (BATCH, None, None))
    f, aux = _ffn_block(lp, common.rms_norm(x, lp["ln2"]), cfg)
    # sequence-parallel layer boundary (Megatron SP), as in JAX
    return constrain(x + f, (BATCH, "model", None)), aux


def forward(params: TransformerParams, tokens: torch.Tensor, cfg: TransformerConfig):
    """Full forward over ``tokens [B, S]``. Returns (hidden [B, S, D], aux);
    ``aux`` is the MoE balance loss summed over the layers (0.0 dense).
    With gradients enabled and ``cfg.remat`` each layer is checkpointed."""
    x = constrain(_embed(params, tokens, cfg), (BATCH, None, None))
    pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    whole = params.whole_layer if params.gathers else None
    for lp in params.layer_list():
        if remat:
            x, aux_l = checkpoint(_layer_fn, lp, x, pos, cfg, whole, use_reentrant=False)
        else:
            x, aux_l = _layer_fn(lp, x, pos, cfg, whole)
        aux = aux + aux_l
    return common.rms_norm(x, params.ln_f), aux


def loss_fn(params: TransformerParams, batch, cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross-entropy + 0.01 · the MoE balance loss; batch =
    {tokens [B, S], labels [B, S]}."""
    hidden, aux = forward(params, batch["tokens"], cfg)
    logits = logits_from_hidden(params, hidden, cfg)
    ce = common.softmax_cross_entropy(logits, batch["labels"])
    return ce + 0.01 * aux


def logits_from_hidden(params: TransformerParams, hidden, cfg):
    table = params.whole("embed" if cfg.tie_embeddings else "unembed")
    return constrain(hidden @ table.T, (BATCH, None, "model"))  # keep vocab sharded


# ---------------------------------------------------------------------------
# serving: prefill + decode


def cache_len(cfg: TransformerConfig, seq_len: int) -> int:
    """SWA models only retain a window of KV (ring buffer at deploy time)."""
    if cfg.swa_window is not None:
        return min(seq_len, cfg.swa_window)
    return seq_len


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int, dtype=None, device="cuda"):
    dtype = dtype or cfg.cdtype
    dev = resolve_device(device)
    c = cache_len(cfg, seq_len)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "length": torch.zeros(batch, dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def decode_step_(params: TransformerParams, cache, tokens: torch.Tensor, cfg: TransformerConfig):
    """One decode step, in place: tokens [B, 1] + cache → logits [B, V].

    The cache is dense [L, B, C, Hkv, Dh]; ``length`` counts the tokens
    seen. Token ``p`` lives in slot ``p % C`` (a ring buffer for SWA
    models, C == window). The current token's K/V is attended to from this
    call, not from the cache, and is written to its slot after the layer's
    attention; ``length`` advances by one at the end. Every cache tensor is
    updated in place.
    """
    b = tokens.shape[0]
    c = cache["k"].shape[2]
    length = cache["length"]  # [B] int32
    x = _embed(params, tokens, cfg)
    q_pos = length[:, None]  # true position ids [B, 1]
    slot = (length % c).long()  # ring-buffer slot [B]
    # absolute position held by each cache slot: slot i holds position p with
    # p ≡ i (mod c) and length - c ≤ p < length (ring-buffer reconstruction)
    slots = torch.arange(c, dtype=torch.int32, device=x.device)[None]  # [1, C]
    base = length[:, None] - 1 - ((length[:, None] - 1 - slots) % c)
    k_pos = torch.where(length[:, None] > 0, base, 0)
    kv_mask = (slots < length[:, None]) | (length[:, None] >= c)

    # the concatenated KV is [cache slots..., current token]
    k_pos_full = torch.cat([k_pos, q_pos], dim=1)
    kv_mask_full = torch.cat(
        [kv_mask, torch.ones((b, 1), dtype=torch.bool, device=x.device)], dim=1
    )
    bidx = torch.arange(b, device=x.device)
    for i in range(cfg.n_layers):
        lp = params.whole_layer(params.layer(i))
        kc, vc = cache["k"][i], cache["v"][i]
        a, nk, nv = _attn_block(
            lp, common.rms_norm(x, lp["ln1"]), q_pos, k_pos_full, cfg,
            k_cache=kc, v_cache=vc, kv_mask=kv_mask_full,
        )
        x = x + a
        x = x + _ffn_block(lp, common.rms_norm(x, lp["ln2"]), cfg)[0]
        kc[bidx, slot] = nk[:, 0]
        vc[bidx, slot] = nv[:, 0]
    x = common.rms_norm(x, params.ln_f)
    logits = logits_from_hidden(params, x, cfg)[:, 0]
    length += 1
    return logits


@torch.no_grad()
def prefill(params: TransformerParams, tokens: torch.Tensor, cfg: TransformerConfig,
            capacity: int = 0, full_logits: bool = True):
    """Full-sequence prefill: returns (logits, cache).

    ``capacity`` sets the KV ring-buffer size (0 ⇒ ``cache_len(cfg, s)``).
    The cache keeps the last ``min(s, capacity)`` positions, position ``p``
    in slot ``p % capacity``, so decode_step_ can reconstruct absolute
    positions. ``full_logits=False`` (serving) unembeds only the final
    position.
    """
    b, s = tokens.shape
    c = capacity or cache_len(cfg, s)
    keep = min(s, c)
    x = _embed(params, tokens, cfg)
    dev = x.device
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    kept_slots = torch.arange(s - keep, s, device=dev) % c
    shape = (cfg.n_layers, b, c, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.zeros(shape, dtype=x.dtype, device=dev)
    vs = torch.zeros(shape, dtype=x.dtype, device=dev)
    for i in range(cfg.n_layers):
        lp = params.whole_layer(params.layer(i))
        a, nk, nv = _attn_block(lp, common.rms_norm(x, lp["ln1"]), pos, pos, cfg)
        x = constrain(x + a, (BATCH, None, None))
        x = x + _ffn_block(lp, common.rms_norm(x, lp["ln2"]), cfg)[0]
        x = constrain(x, (BATCH, "model", None))
        ks[i][:, kept_slots] = nk[:, s - keep:]
        vs[i][:, kept_slots] = nv[:, s - keep:]
    x = common.rms_norm(x, params.ln_f)
    if full_logits:
        logits = logits_from_hidden(params, x, cfg)
    else:
        last = constrain(x[:, -1:, :], (BATCH, None, None))
        logits = logits_from_hidden(params, last, cfg)[:, 0]
    cache = {
        "k": ks,
        "v": vs,
        "length": torch.full((b,), s, dtype=torch.int32, device=dev),
    }
    return logits, cache


# ---------------------------------------------------------------------------
# dry-run input specs


def input_specs(cfg: TransformerConfig, shape: str, seq_len: int, batch: int,
                device="cuda") -> Dict[str, Any]:
    """Fake tensors of a step's batch (the JAX package's ``input_specs``):
    ``train`` int32 tokens and labels ``[B, S]``, ``prefill`` tokens, and
    ``decode`` one token ``[B, 1]`` with the cache :func:`init_cache` makes
    (``[L, B, C, Hkv, Dh]`` in the compute dtype, int32 ``length [B]``)."""
    i32 = torch.int32
    fake = common.fake_tensor
    if shape == "train":
        return {"tokens": fake((batch, seq_len), i32, device),
                "labels": fake((batch, seq_len), i32, device)}
    if shape == "prefill":
        return {"tokens": fake((batch, seq_len), i32, device)}
    if shape == "decode":
        kv = (cfg.n_layers, batch, cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.head_dim)
        return {
            "tokens": fake((batch, 1), i32, device),
            "cache": {"k": fake(kv, cfg.cdtype, device), "v": fake(kv, cfg.cdtype, device),
                      "length": fake((batch,), i32, device)},
        }
    raise ValueError(shape)
