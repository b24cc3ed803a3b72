"""Decoder-only LM: init, forward and loss with gradients, prefill and
decode-step.

The JAX package's ``repro.models.transformer.model`` on torch tensors.
Parameters live in a :class:`TransformerParams` module with layer-stacked
tensors (``[L, ...]``, as the JAX tree stacks them for ``lax.scan``); the
layer loop is a Python loop. Prefill attention goes through the
``flash_attention`` kernel (``attention.attention_chunked``); the decode
step's attention over the ring-buffer cache is plain tensor code
(``attention.attention_dense``), as in the JAX package, whose dispatch
takes the dense attention for a single query.

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

On a multi-rank mesh (``dist.sharding.activate``) every config runs
tensor- and sequence-parallel over the ``model`` axis, as JAX's specs and
``constrain`` calls lay it out (:func:`tensor_parallel`,
``dist.sharding.model_axis``; the ranks of one data shard hold the same
rows):

* each rank uses its own ``model`` block of every weight: the
  column-parallel ``wq``/``wk``/``wv`` and ``w1``/``w3`` for its query heads
  and ``d_ff/m`` columns, the row-parallel ``wo``/``w2`` for the matching
  rows, the vocabulary's ``V/m`` rows of ``embed``/``unembed``. Where
  JAX's ``_maybe`` drops ``model`` from the query heads (``H % m``) every
  rank attends with all of them, as GSPMD's replicated heads; where it
  drops it from the kv heads (``Hkv % m``, the kv heads then gathered
  whole) each rank computes the kv heads its query heads read
  (:func:`head_plan`);
* the residual between sub-blocks is split over the sequence (Megatron
  SP, JAX's ``(BATCH, "model", None)`` boundary): a sub-block all-gathers
  its normed input (``dist.collectives.all_gather_sum``) and
  reduce-scatters its float32 partial product back
  (``reduce_scatter_dim``), summed in float32 and rounded once; a sequence
  the axis does not divide (the decode step's one token) stays whole, the
  partials all-reduced;
* an MoE layer's FFN runs its routed experts expert-parallel
  (``moe.moe_ffn_ep``) on the whole gathered input, as JAX's
  ``shard_map`` does, each rank its ``E/m`` experts, the combine handing
  every rank the whole routed output; the rank adds its block of it to
  the reduce-scattered partial of the shared experts, which take the
  dense FFN's split (the rank's ``shared_ff/m`` columns of ``w1``/``w3``
  and rows of ``w2``: JAX's column- and row-parallel specs of
  ``moe/shared``). ``moe_ffn_ep`` leaves the input's gradient this rank's
  partial, summed over the ranks by the gather's backward with the shared
  experts' (:func:`_ffn_block`, :func:`_leave`). Where the axis does not
  divide the experts (JAX's ``_moe_ffn_local``, the expert stacks whole)
  every rank computes the routed FFN whole, its gradient counted on the
  first rank (``dist.collectives.counted_once``);
* the embedding is a masked lookup of the rank's vocabulary rows summed
  over the ranks; the logits stay ``[B, S, V/m]`` (JAX's vocab-sharded
  ``constrain``) and the loss is the vocabulary-split cross-entropy
  (``common.softmax_cross_entropy``);
* the prefill's cache is ``lm_cache_spec``'s layout: the rank's ``C/m``
  slots, every kv head (a heads-to-slots all-to-all of the kept K/V);
  :func:`decode_step_` attends with all query heads over the rank's own
  slots, its softmax normalised by the log-sum-exp over every rank's and
  the ranks' float32 ``P·V`` summed (``attention.attention_partial``).

A replicated leaf used for a rank's share (the norms under sequence
parallelism, ``q_norm``/``k_norm`` on its heads, the rank's slices of
``bq``/``bk``/``bv``) enters through ``dist.collectives.copy_in``, which
sums its gradient over the ranks. A one-rank mesh, or none, takes the
same code on :data:`ONE_RANK`: no collective, the whole of every weight,
plain products in the compute dtype; an MoE layer's FFN is then
``moe.moe_ffn`` with its shared experts, expert-parallel on a mesh whose
model axis has one rank (the trainer's ``(world, 1)``).

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

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import ModelAxis, active_mesh, model_axis
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
# the model axis: tensor and sequence parallelism


#: no tensor parallelism: one rank holds every head, column, vocabulary row
#: and cache slot, and the hooks below call no collective
ONE_RANK = ModelAxis(None, 1, 0)


def tensor_parallel(mesh) -> bool:
    """Whether an LM runs tensor-parallel on ``mesh``: on a model axis of
    several ranks, dense and MoE configs alike (an MoE's routed experts
    split over it, ``moe.moe_ffn_ep``). The one place that decides it."""
    return mesh is not None and mesh.shape.get("model", 1) > 1


def _axis() -> ModelAxis:
    """The active mesh's model axis where the LM runs tensor-parallel on
    it (:func:`tensor_parallel`, a process group behind it), else
    :data:`ONE_RANK`."""
    if tensor_parallel(active_mesh()):
        return model_axis() or ONE_RANK
    return ONE_RANK


def head_plan(cfg: TransformerConfig, tp: ModelAxis) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``((q0, q1), (k0, k1))``: the query heads this rank attends with and
    the kv heads they read. ``H % m`` (JAX's ``_maybe`` drops ``model``
    from the heads): all of them on every rank. Otherwise the rank's block
    of ``H/m`` query heads, with the rank's block of kv heads where ``m``
    divides them, else the kv heads that block reads (the GQA groups must
    map evenly onto it)."""
    h, hkv, m, r = cfg.n_heads, cfg.n_kv_heads, tp.size, tp.rank
    if h % m:
        return (0, h), (0, hkv)
    q0, q1 = r * h // m, (r + 1) * h // m
    if hkv % m == 0:
        return (q0, q1), (r * hkv // m, (r + 1) * hkv // m)
    g = h // hkv
    k0, k1 = q0 // g, (q1 - 1) // g + 1
    nq, nk = q1 - q0, k1 - k0
    if nq % nk or any((q0 + i) // g - k0 != i // (nq // nk) for i in range(nq)):
        raise NotImplementedError(f"{h} query heads over {hkv} kv heads on a model axis of "
                                  f"{m}: rank {r}'s heads read their kv heads unevenly")
    return (q0, q1), (k0, k1)


def _copy_in(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """A replicated leaf used for this rank's share: its gradient summed
    over the ranks."""
    return x if tp.size == 1 else coll.copy_in(x, tp.group)


def _take(w: torch.Tensor, n: int, cols: slice, tp: ModelAxis, dim: int = -1) -> torch.Tensor:
    """The block ``cols`` of a leaf whose size along ``dim`` is ``n``
    whole: held whole (sliced; ``copy_in`` sums its gradient over the
    ranks), held as this rank's ``model`` block (used as it is when that is
    the block asked for), or gathered whole over ``model`` and sliced (its
    gradient reduce-scattered, summed)."""
    if w.shape[dim] == n:
        w = _copy_in(w, tp)
        if (cols.start, cols.stop) == (0, n):
            return w
        return w.narrow(dim, cols.start, cols.stop - cols.start)
    own = tp.block(n)
    if w.shape[dim] != own.stop - own.start:
        raise ValueError(f"a leaf of {w.shape[dim]} along {dim}: neither {n} whole nor a "
                         f"block of {tp.size}")
    if (cols.start, cols.stop) == (own.start, own.stop):
        return w
    return coll.all_gather_sum(w, dim, tp.group).narrow(dim, cols.start,
                                                        cols.stop - cols.start)


def _heads(a: int, b: int, hd: int) -> slice:
    return slice(a * hd, b * hd)


def _mm(a: torch.Tensor, w: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """``a @ w`` of a row-parallel block: on several ranks the rank's float32
    partial (``common.partial_matmul``), summed over them and rounded once
    by :func:`_leave`."""
    return a @ w if tp.size == 1 else common.partial_matmul(a, w)


def _enter(h: torch.Tensor, tp: ModelAxis, sp: bool) -> torch.Tensor:
    """A sub-block's input: the sequence-split ``h`` gathered whole (its
    partial cotangents reduce-scattered), or the replicated ``h`` (its
    partial cotangents all-reduced)."""
    if tp.size == 1:
        return h
    return coll.all_gather_sum(h, 1, tp.group) if sp else coll.copy_in(h, tp.group)


def _leave(partial, x: torch.Tensor, tp: ModelAxis, sp: bool, routed=None) -> torch.Tensor:
    """``x`` plus the sub-block's output; on several ranks their float32
    partial products summed over them and rounded once: reduce-scattered
    onto this rank's block of the sequence, or all-reduced. ``routed`` (an
    MoE's routed output, several ranks only) is a part of the output every
    rank holds whole: added as this rank's block of the sequence (its
    backward gathers the whole cotangent), or whole, never summed over the
    ranks; ``partial`` is then ``None`` where there is no shared expert."""
    if tp.size == 1:
        return x + partial
    y = None
    if partial is not None:
        y = coll.reduce_scatter_dim(partial, 1, tp.group) if sp else coll.psum(partial, tp.group)
    if routed is not None:
        r = coll.own_block(routed, 1, tp.group) if sp else routed
        y = r if y is None else y + r
    return x + y.to(x.dtype)


def _norm(gamma: torch.Tensor, tp: ModelAxis, sp: bool) -> torch.Tensor:
    """A norm's gain: on a rank's block of the sequence its gradient is the
    block's, summed over the ranks; on the replicated residual every rank's
    is the whole one."""
    return _copy_in(gamma, tp) if sp else gamma


def _slot_block(c: int, tp: ModelAxis) -> slice:
    """This rank's block of a cache's ``c`` slots."""
    if c % tp.size:
        raise NotImplementedError(f"a cache of {c} slots on a model axis of {tp.size}: the "
                                  f"port holds it split over the axis only")
    return tp.block(c)


# ---------------------------------------------------------------------------
# forward


def project_qkv(p, x, pos, cfg: TransformerConfig, tp: ModelAxis = ONE_RANK,
                q_heads=None, kv_heads=None):
    """q ``[B, S, Hq, Dh]`` and k, v ``[B, S, Hk, Dh]`` of one layer for the
    query heads ``q_heads`` and kv heads ``kv_heads`` (``(first, end)``,
    all by default): the projections, biases, qk-norm, and RoPE at ``pos``
    (k too is rotated with the query positions, as in the JAX package)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q_heads, kv_heads = q_heads or (0, h), kv_heads or (0, hkv)
    qc, kc = _heads(*q_heads, hd), _heads(*kv_heads, hd)
    q = x @ _take(p["wq"], h * hd, qc, tp)
    k = x @ _take(p["wk"], hkv * hd, kc, tp)
    v = x @ _take(p["wv"], hkv * hd, kc, tp)
    if cfg.qkv_bias:
        q = q + _take(p["bq"], h * hd, qc, tp)
        k = k + _take(p["bk"], hkv * hd, kc, tp)
        v = v + _take(p["bv"], hkv * hd, kc, tp)
    q = q.reshape(b, s, q_heads[1] - q_heads[0], hd)
    k = k.reshape(b, s, kv_heads[1] - kv_heads[0], hd)
    v = v.reshape(b, s, kv_heads[1] - kv_heads[0], hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, _copy_in(p["q_norm"], tp))
        k = common.rms_norm(k, _copy_in(p["k_norm"], tp))
    q = attn_mod.apply_rope(q, pos, cfg.rope_theta)
    k = attn_mod.apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _attn_block(p, h, pos, cfg: TransformerConfig, tp: ModelAxis, kv_heads=None):
    """The attention sub-block on the whole sequence ``h [B, S, D]``: (this
    rank's partial of its output, k, v of ``kv_heads``, by default those
    the rank's query heads read). The flash kernel runs on the rank's query
    heads (:func:`head_plan`); the row-parallel ``wo`` takes its block."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    (q0, q1), (k0, k1) = head_plan(cfg, tp)
    kv_heads = kv_heads or (k0, k1)
    q, k, v = project_qkv(p, h, pos, cfg, tp, (q0, q1), kv_heads)
    read = slice(k0 - kv_heads[0], k1 - kv_heads[0])
    # positions None: 0..S−1, the flash kernel's index route
    out = attn_mod.attention(q, k[:, :, read], v[:, :, read], None, None, cfg, causal=True)
    own = tp.block(cfg.n_heads * hd)
    out = out.reshape(b, s, (q1 - q0) * hd)[..., own.start - q0 * hd:own.stop - q0 * hd]
    return _mm(out, _take(p["wo"], cfg.n_heads * hd, own, tp, dim=-2), tp), k, v


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


def _swiglu(h, w1, w3, w2, n: int, tp: ModelAxis):
    """This rank's partial of a SwiGLU of width ``n``: its ``n/m`` columns
    of ``w1``/``w3`` and rows of ``w2``."""
    own = tp.block(n)
    a = F.silu(h @ _take(w1, n, own, tp)) * (h @ _take(w3, n, own, tp))
    return _mm(a, _take(w2, n, own, tp, dim=-2), tp)


def _ffn_block(p, h, cfg: TransformerConfig, tp: ModelAxis = ONE_RANK):
    """The FFN sub-block on the whole sequence ``h [B, S, D]``: (this rank's
    partial of y, the routed part of y every rank holds whole or ``None``,
    aux), aux the MoE balance loss (0.0 dense); :func:`_leave` adds them.
    A dense rank takes its ``d_ff/m`` columns of ``w1``/``w3`` and rows of
    ``w2``. An MoE layer on one rank is ``moe.moe_ffn`` whole; on several
    its routed experts run expert-parallel on all of ``h`` (or whole on
    every rank where the axis does not divide them) and its shared experts
    take the dense split (see module)."""
    if cfg.moe is None:
        return _swiglu(h, p["ffn_w1"], p["ffn_w3"], p["ffn_w2"], cfg.d_ff, tp), None, 0.0
    b, s, d = h.shape
    mp = moe_params(p)
    if tp.size == 1:
        y, aux = moe_mod.moe_ffn(h.reshape(b * s, d), mp, cfg.moe)
        return y.reshape(b, s, d), None, aux
    shared = mp.pop("shared", None)
    flat = h.reshape(b * s, d)
    plan = moe_mod.ep_plan(b * s, cfg.moe)
    if plan is None:  # JAX's local FFN, whole on every rank, its gradient counted once
        e = cfg.moe.n_experts
        mp = {k: _take(w, e, slice(0, e), tp, dim=-1 if k == "router" else 0)
              for k, w in mp.items()}
        y, aux = (coll.counted_once(t, tp.group) for t in moe_mod.moe_ffn_local(flat, mp, cfg.moe))
    else:
        y, aux = moe_mod.moe_ffn_ep(flat, mp, cfg.moe, *plan, x_summed=True)
    partial = None if shared is None else _swiglu(h, shared["w1"], shared["w3"], shared["w2"],
                                                  cfg.moe.shared_ff, tp)
    return partial, y.reshape(b, s, d), aux


def _embed(params: TransformerParams, tokens, cfg, tp: ModelAxis = ONE_RANK, sp: bool = False):
    """The embedding; on several ranks from this rank's vocabulary rows (a
    masked lookup), summed over the ranks: reduce-scattered onto this
    rank's block of the sequence (``sp``), or all-reduced. One rank's term
    is the row, the others' zero: the sum is exact in the compute dtype."""
    if tp.size == 1:
        return params.whole("embed")[tokens.long()].to(cfg.cdtype)
    own = tp.block(cfg.vocab_size)
    n = own.stop - own.start
    table = _take(params.whole("embed"), cfg.vocab_size, own, tp, dim=0)
    ids = tokens.long() - own.start
    inside = (ids >= 0) & (ids < n)
    e = torch.where(inside[..., None], table[ids.clamp(0, n - 1)], 0).to(cfg.cdtype)
    return coll.reduce_scatter_dim(e, 1, tp.group) if sp else coll.psum(e, tp.group)


def _layer_fn(lp, x, pos, cfg, whole, tp: ModelAxis, sp: bool):
    """One layer of the forward: (x after the layer, its MoE aux); ``x``
    this rank's block of the sequence (``sp``) or whole. ``whole`` gathers
    the layer's sharded weights (``TransformerParams.whole_layer``)."""
    if whole is not None:
        lp = whole(lp)
    a, _, _ = _attn_block(lp, _enter(common.rms_norm(x, _norm(lp["ln1"], tp, sp)), tp, sp),
                          pos, cfg, tp)
    x = _leave(a, x, tp, sp)
    f, routed, aux = _ffn_block(lp, _enter(common.rms_norm(x, _norm(lp["ln2"], tp, sp)), tp, sp),
                                cfg, tp)
    return _leave(f, x, tp, sp, routed), aux


def forward(params: TransformerParams, tokens: torch.Tensor, cfg: TransformerConfig):
    """Full forward over ``tokens [B, S]``. Returns (hidden [B, S, D], aux);
    ``aux`` is the MoE balance loss summed over the layers (0.0 dense).
    With gradients enabled and ``cfg.remat`` each layer is checkpointed.
    Tensor-parallel, the hidden states come back whole on every rank (the
    last gather's backward sums the ranks' cotangents)."""
    tp = _axis()
    s = tokens.shape[1]
    sp = s % tp.size == 0
    x = _embed(params, tokens, cfg, tp, sp)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    whole = params.whole_layer if params.gathers else None
    for lp in params.layer_list():
        if remat:
            x, aux_l = checkpoint(_layer_fn, lp, x, pos, cfg, whole, tp, sp, use_reentrant=False)
        else:
            x, aux_l = _layer_fn(lp, x, pos, cfg, whole, tp, sp)
        aux = aux + aux_l
    return _enter(common.rms_norm(x, _norm(params.ln_f, tp, sp)), tp, sp), aux


def loss_fn(params: TransformerParams, batch, cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross-entropy + 0.01 · the MoE balance loss; batch =
    {tokens [B, S], labels [B, S]}."""
    hidden, aux = forward(params, batch["tokens"], cfg)
    logits = logits_from_hidden(params, hidden, cfg)
    tp = _axis()
    vocab = None if tp.size == 1 else (tp.block(cfg.vocab_size).start, tp.group)
    ce = common.softmax_cross_entropy(logits, batch["labels"], vocab)
    return ce + 0.01 * aux


def logits_from_hidden(params: TransformerParams, hidden, cfg):
    """``hidden @ tableᵀ``; tensor-parallel, this rank's ``V/m`` vocabulary
    columns (``hidden`` whole on every rank), as JAX keeps them sharded."""
    table = params.whole("embed" if cfg.tie_embeddings else "unembed")
    tp = _axis()
    return hidden @ _take(table, cfg.vocab_size, tp.block(cfg.vocab_size), tp, dim=0).T


# ---------------------------------------------------------------------------
# serving: prefill + decode


def cache_len(cfg: TransformerConfig, seq_len: int) -> int:
    """SWA models only retain a window of KV (ring buffer at deploy time)."""
    if cfg.swa_window is not None:
        return min(seq_len, cfg.swa_window)
    return seq_len


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int, dtype=None, device="cuda"):
    """An empty cache ``[L, B, C, Hkv, Dh]``; tensor-parallel, this rank's
    ``C/m`` slots of it (``lm_cache_spec``'s layout)."""
    dtype = dtype or cfg.cdtype
    dev = resolve_device(device)
    mine = _slot_block(cache_len(cfg, seq_len), _axis())
    shape = (cfg.n_layers, batch, mine.stop - mine.start, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "length": torch.zeros(batch, dtype=torch.int32, device=dev),
    }


def _qkv_whole(p, h, pos, cfg: TransformerConfig, tp: ModelAxis):
    """q, k, v of every head of the replicated ``h [B, 1, D]``; on several
    ranks each its ``model`` block of the projections' columns, gathered
    over the ranks (a token's q, k, v move; the weights stay)."""
    b, s, _ = h.shape
    h_, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def cols(w, bias, n):
        own = tp.block(n)
        y = h @ _take(w, n, own, tp)
        if bias is not None:
            y = y + _take(bias, n, own, tp)
        return y if tp.size == 1 else coll.all_gather_sum(y, -1, tp.group)

    bias = (lambda name: p[name]) if cfg.qkv_bias else (lambda name: None)
    q = cols(p["wq"], bias("bq"), h_ * hd).reshape(b, s, h_, hd)
    k = cols(p["wk"], bias("bk"), hkv * hd).reshape(b, s, hkv, hd)
    v = cols(p["wv"], bias("bv"), hkv * hd).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"])
        k = common.rms_norm(k, p["k_norm"])
    return (attn_mod.apply_rope(q, pos, cfg.rope_theta),
            attn_mod.apply_rope(k, pos, cfg.rope_theta), v)


@torch.no_grad()
def decode_step_(params: TransformerParams, cache, tokens: torch.Tensor, cfg: TransformerConfig):
    """One decode step, in place: tokens [B, 1] + cache → logits [B, V].

    The cache is dense [L, B, C, Hkv, Dh]; ``length`` counts the tokens
    seen. Token ``p`` lives in slot ``p % C`` (a ring buffer for SWA
    models, C == window). The current token's K/V is attended to from this
    call, not from the cache, and is written to its slot after the layer's
    attention; ``length`` advances by one at the end. Every cache tensor is
    updated in place. Tensor-parallel, the cache is this rank's block of
    ``C/m`` slots and the logits its ``V/m`` columns: every query head
    attends over the rank's slots, the current token by the first rank,
    with the softmax and ``P·V`` reduced over the ranks in float32; the
    rank that owns the token's slot writes it (see module).
    """
    tp = _axis()
    b = tokens.shape[0]
    c_loc = cache["k"].shape[2]
    c, lo = c_loc * tp.size, tp.rank * c_loc
    length = cache["length"]  # [B] int32
    x = _embed(params, tokens, cfg, tp)
    dev = x.device
    q_pos = length[:, None]  # true position ids [B, 1]
    slot = (length % c).long()  # ring-buffer slot [B]
    # absolute position held by each cache slot: slot i holds position p with
    # p ≡ i (mod c) and length - c ≤ p < length (ring-buffer reconstruction)
    slots = lo + torch.arange(c_loc, dtype=torch.int32, device=dev)[None]  # [1, C/m]
    base = length[:, None] - 1 - ((length[:, None] - 1 - slots) % c)
    k_pos = torch.where(length[:, None] > 0, base, 0)
    kv_mask = (slots < length[:, None]) | (length[:, None] >= c)
    first = tp.rank == 0
    if first:  # the concatenated KV is [cache slots..., current token]
        k_pos = torch.cat([k_pos, q_pos], dim=1)
        kv_mask = torch.cat([kv_mask, torch.ones((b, 1), dtype=torch.bool, device=dev)], dim=1)
    owned = ((slot >= lo) & (slot < lo + c_loc))[:, None, None]
    local = (slot - lo).clamp(0, c_loc - 1)
    bidx = torch.arange(b, device=dev)
    width = cfg.n_heads * cfg.head_dim
    own = tp.block(width)
    for i in range(cfg.n_layers):
        lp = params.whole_layer(params.layer(i))
        q, nk, nv = _qkv_whole(lp, common.rms_norm(x, lp["ln1"]), q_pos, cfg, tp)
        kc, vc = cache["k"][i], cache["v"][i]
        k, v = (torch.cat([kc, nk], dim=1), torch.cat([vc, nv], dim=1)) if first else (kc, vc)
        if tp.size == 1:
            out = attn_mod.attention(q, k, v, q_pos, k_pos, cfg, causal=True, kv_mask=kv_mask)
        else:
            out = attn_mod.attention_partial(q, k, v, q_pos, k_pos, tp.group,
                                             window=cfg.swa_window, kv_mask=kv_mask).to(x.dtype)
        out = out.reshape(b, 1, width)[..., own]
        x = _leave(_mm(out, _take(lp["wo"], width, own, tp, dim=-2), tp), x, tp, False)
        f, routed, _ = _ffn_block(lp, common.rms_norm(x, lp["ln2"]), cfg, tp)
        x = _leave(f, x, tp, False, routed)
        del f, routed
        kc[bidx, local] = torch.where(owned, nk[:, 0], kc[bidx, local])
        vc[bidx, local] = torch.where(owned, nv[:, 0], vc[bidx, local])
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
    position. Tensor-parallel, the cache is this rank's block of ``C/m``
    slots (every kv head: a heads-to-slots exchange of the kept K/V where
    the ranks split the kv heads) and the logits its ``V/m`` columns.
    """
    tp = _axis()
    b, s = tokens.shape
    c = capacity or cache_len(cfg, s)
    keep = min(s, c)
    mine = _slot_block(c, tp)
    sp = s % tp.size == 0
    x = _embed(params, tokens, cfg, tp, sp)
    dev = x.device
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    kept_slots = torch.arange(s - keep, s, device=dev) % c
    hkv = cfg.n_kv_heads
    # the kv heads this rank computes: its own block (exchanged for its
    # slots of every head), or all of them (the kv heads held whole)
    kv = head_plan(cfg, tp)[1]
    split = kv[1] - kv[0] < hkv and hkv % tp.size == 0
    kv = kv if split else (0, hkv)
    shape = (cfg.n_layers, b, mine.stop - mine.start, hkv, cfg.head_dim)
    ks = torch.zeros(shape, dtype=x.dtype, device=dev)
    vs = torch.zeros(shape, dtype=x.dtype, device=dev)
    for i in range(cfg.n_layers):
        lp = params.whole_layer(params.layer(i))
        a, nk, nv = _attn_block(lp, _enter(common.rms_norm(x, lp["ln1"]), tp, sp), pos, cfg, tp,
                                kv)
        x = _leave(a, x, tp, sp)
        f, routed, _ = _ffn_block(lp, _enter(common.rms_norm(x, lp["ln2"]), tp, sp), cfg, tp)
        x = _leave(f, x, tp, sp, routed)
        del f, routed  # not alive through the next layer
        for new, held in ((nk, ks[i]), (nv, vs[i])):
            ring = held if tp.size == 1 else new.new_zeros((b, c) + new.shape[2:])
            ring[:, kept_slots] = new[:, s - keep:]
            if tp.size > 1:
                held.copy_(coll.all_to_all_dim(ring, 1, 2, tp.group) if split else ring[:, mine])
    x = common.rms_norm(x, params.ln_f)
    if full_logits:
        logits = logits_from_hidden(params, _enter(x, tp, sp), cfg)
    else:
        logits = logits_from_hidden(params, _enter(x[:, -1:], tp, sp)[:, -1:], cfg)[:, 0]
    cache = {"k": ks, "v": vs, "length": torch.full((b,), s, dtype=torch.int32, device=dev)}
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
