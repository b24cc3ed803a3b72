"""Mixture-of-Experts FFN with sort-based token dispatch.

The JAX package's ``repro.models.transformer.moe``: ``route``,
``dispatch_indices``, ``capacity``, ``_moe_ffn_local`` (here
:func:`moe_ffn_local`) and the expert-parallel :func:`moe_ffn_ep`, which
:func:`moe_ffn` takes on a multi-rank mesh with a ``model`` axis when the
mesh divides the experts and the tokens (the JAX dispatch rule).

The JAX module builds its dispatch on the Pregel substrate's gather and
scatter-with-combiner primitives; here those primitives are the kernels
(tokens flattened to T = B·S, k = top_k, E = n_experts, C = capacity):

1. the router in float32, softmax, top-k, gates normalised over the k;
2. each (token, slot)'s position in its expert by a stable sort of the
   expert ids; slots past C are dropped (the GShard policy);
3. dispatch: an inverse map ``src [E·C]`` (token of each expert slot, the
   sentinel T where no token landed) read by ``graph.ops.gather`` in fill
   mode — one ``gather_rows`` launch gives the ``[E·C, D]`` expert input
   with zero rows for the empty slots, the JAX module's zero buffer plus
   scatter-add of ``x[token_id]`` (each kept slot is written once);
4. per-expert SwiGLU by ``torch.bmm`` over ``[E, C, D] × [E, D, F]``;
5. combine: ``graph.ops.gather`` of each (token, slot)'s expert row in
   clip mode (a dropped slot reads the last row and is weighted 0, so a
   NaN there still spreads, as in JAX), times its gate, then
   ``graph.ops.segment_reduce`` "sum" over the k rows of each token
   (sorted ids, offsets ``k·arange(T+1)``): one ``gather_rows`` and one
   ``segment_reduce`` launch. The segment sum accumulates in float32 and
   rounds once; JAX's scatter-add accumulates in the input dtype.

Shared experts (DeepSeekMoE) are a dense SwiGLU over all tokens, added in.
Gradients flow through the gates to the router and through both graph
ops (``kernels.autograd``); the in-place products of serving are taken
out of place when either factor requires a gradient.
:func:`moe_ffn` counts the slots it routed and dropped in
``moe_ffn.slots`` and ``moe_ffn.dropped`` (the latter a device tensor once
anything is added, so that counting costs no host sync).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.graph import ops as graph_ops
from repro_torch.models import common
from repro_torch.models.transformer.config import MoEConfig


def init_moe_params(gen: torch.Generator, d_model: int, mcfg: MoEConfig, dtype):
    """Random MoE parameters from ``gen`` on its device, with the JAX
    module's leaf names and distributions (not its bits): ``router``
    float32 ``[D, E]`` N(0, 1/D); ``w1``/``w3`` ``[E, D, F]`` N(0, 1/D);
    ``w2`` ``[E, F, D]`` N(0, 1/F); with shared experts ``shared/{w1,w3,w2}``
    likewise at the shared width. Each draw is float32, then cast."""
    e, f = mcfg.n_experts, mcfg.d_ff_expert

    def normal(shape, scale, dt):
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dt)

    s = 1.0 / math.sqrt(d_model)
    params: Dict = {
        "router": normal((d_model, e), s, torch.float32),
        "w1": normal((e, d_model, f), s, dtype),
        "w3": normal((e, d_model, f), s, dtype),
        "w2": normal((e, f, d_model), 1.0 / math.sqrt(f), dtype),
    }
    if mcfg.n_shared_experts:
        sf = mcfg.shared_ff
        params["shared"] = {
            "w1": normal((d_model, sf), s, dtype),
            "w3": normal((d_model, sf), s, dtype),
            "w2": normal((sf, d_model), 1.0 / math.sqrt(sf), dtype),
        }
    return params


def capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    """Slots an expert takes: ``ceil(T·k·capacity_factor / E)``, at least 8
    and rounded up to a multiple of 8, as the JAX module computes it."""
    c = int(math.ceil(n_tokens * mcfg.top_k * mcfg.capacity_factor / mcfg.n_experts))
    return max(8, -(-c // 8) * 8)


def route(x: torch.Tensor, router_w: torch.Tensor, mcfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of ``x [T, D]``: (expert_idx int32 [T, k], gate f32
    [T, k], aux). The top k are taken by a stable descending sort, so equal
    probabilities keep the lower expert first, as ``jax.lax.top_k`` does
    (``torch.topk`` leaves their order open). ``aux`` is the Switch-style
    balance loss: E · Σ_e (share of tokens whose first choice is e) · (mean
    probability of e)."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)  # [T, E]
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[:, :mcfg.top_k], expert_idx[:, :mcfg.top_k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    density = F.one_hot(expert_idx[:, 0], mcfg.n_experts).float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * mcfg.n_experts
    return expert_idx.to(torch.int32), gate, aux


def dispatch_indices(expert_idx: torch.Tensor, n_experts: int, cap: int):
    """Position of each (token, slot) within its expert, by a stable sort
    of the flattened ids ``[T·k]`` (token-major), so an expert's slots
    go to its tokens in (token, slot) order. Returns (pos int32 [T·k],
    keep bool [T·k]); ``keep = pos < cap``. The stable sort is what JAX's
    ``jnp.argsort`` gives; an unstable one would drop other slots."""
    flat = expert_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = torch.zeros(n_experts, dtype=torch.int32, device=flat.device)
    counts.index_add_(0, flat.long(), torch.ones_like(flat))  # bincount, no host sync
    starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    rank = torch.arange(flat.shape[0], dtype=torch.int32, device=flat.device)
    rank = rank - starts[sorted_e.long()]
    pos = torch.empty_like(rank)
    pos[order] = rank
    return pos, pos < cap


def dispatch(x: torch.Tensor, slot: torch.Tensor, token_id: torch.Tensor,
             n_slots: int) -> torch.Tensor:
    """The expert input ``[n_slots, D]``: row ``s`` is ``x`` of the token
    whose kept (token, slot) pair has ``slot == s``, 0 where none has.
    ``slot`` is ``n_slots`` for a dropped pair. An inverse map ``src`` of
    the tokens (the sentinel T where no token landed; dropped pairs write
    one extra entry, cut off) read by one fill-mode gather."""
    src = torch.full((n_slots + 1,), x.shape[0], dtype=torch.int32, device=x.device)
    src.scatter_(0, slot.long(), token_id)
    return graph_ops.gather(x, src[:-1], fill=0)


def ep_plan(n_tokens: int, mcfg: MoEConfig):
    """``(mesh, daxes, n_data, n_model)`` of :func:`moe_ffn_ep` for ``n_tokens``
    tokens under the active mesh, or ``None`` where :func:`moe_ffn_local`
    runs (see :func:`moe_ffn`)."""
    from repro_torch.dist import sharding as shd

    mesh = shd.active_mesh()
    if mesh is None or mesh.device_mesh is None or "model" not in mesh.shape:
        return None
    n_model = mesh.shape["model"]
    daxes = () if shd.batch_split() else shd.data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in daxes)
    if mcfg.n_experts % n_model or n_tokens % n_data:
        return None
    return mesh, daxes, n_data, n_model


def moe_ffn(x: torch.Tensor, params, mcfg: MoEConfig):
    """``x [T, D]`` → (y [T, D], aux). Under an active multi-rank mesh with a
    ``model`` axis that divides the experts, and data axes (pod × data) that
    divide the tokens, the expert-parallel :func:`moe_ffn_ep` — also when
    ``model`` has size 1, as the trainer's ``(world, 1)`` mesh has it;
    otherwise :func:`moe_ffn_local`, on every rank alike. On a mesh whose
    data axes split the batch already (``dist.sharding.batch_split``: a
    data-parallel step) the tokens are the rank's own and only the
    ``model`` axis splits the experts."""
    plan = ep_plan(x.shape[0], mcfg)
    if plan is not None:
        return moe_ffn_ep(x, params, mcfg, *plan)
    return moe_ffn_local(x, params, mcfg)


def moe_ffn_local(x: torch.Tensor, params, mcfg: MoEConfig):
    """``x [T, D]`` → (y [T, D], aux): the JAX ``_moe_ffn_local`` on the
    port's ``graph.ops`` (see module)."""
    t, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    cap = capacity(t, mcfg)
    expert_idx, gate, aux = route(x, params["router"], mcfg)
    pos, keep = dispatch_indices(expert_idx, e, cap)
    moe_ffn.slots += keep.numel()
    moe_ffn.dropped = moe_ffn.dropped + (keep.numel() - keep.sum())

    dev = x.device
    # the token of each (token, slot), sorted: each of arange(T) k times
    token_id = torch.arange(t, dtype=torch.int32, device=dev)[:, None].expand(t, k).reshape(-1)
    slot = torch.where(keep, expert_idx.reshape(-1) * cap + pos, e * cap)  # [T·k]
    expert_in = dispatch(x, slot, token_id, e * cap).reshape(e, cap, d)

    out_slots = _experts(expert_in, params["w1"], params["w3"], params["w2"])
    del expert_in

    vals = graph_ops.gather(out_slots, slot.clamp(max=e * cap - 1))  # [T·k, D]
    del out_slots
    weight = (gate.reshape(-1) * keep).to(x.dtype)[:, None]
    vals = vals * weight if vals.requires_grad or weight.requires_grad else vals.mul_(weight)
    offsets = torch.arange(0, k * (t + 1), k, dtype=torch.int32, device=dev)
    y = graph_ops.segment_reduce(vals, token_id, t, "sum", offsets=offsets)

    if "shared" in params:
        sh = params["shared"]
        y = y + common.swiglu(x, sh["w1"], sh["w3"], sh["w2"])
    return y, aux


def _experts(expert_in, w1, w3, w2):
    """Per-expert SwiGLU ``[E, C, D] → [E·C, D]`` by ``torch.bmm``."""
    e, cap, d = expert_in.shape
    h = torch.bmm(expert_in, w1)
    g = torch.bmm(expert_in, w3)
    if h.requires_grad or g.requires_grad:  # the backward reads h and g
        h = F.silu(h) * g
    else:  # silu(h) * g in place, each rounded as in JAX
        h = F.silu(h, inplace=True).mul_(g)
    del g
    return torch.bmm(h, w2).reshape(e * cap, d)


def _own_rows(vals, owner, rank: int, group, most_bound: int):
    """The weighted rows ``vals [T·k, D]`` of every (token, slot) from the
    rank that owns its expert, gathered over ``group`` into place (0 for a
    dropped slot). ``owner [T·k]`` names that rank (the group's size for a
    dropped slot); every rank of the group routes the same tokens alike, so
    each works out from it where every rank's rows go, and sends only its
    own (padded to the most any rank holds): one collective of about
    ``T·k·D`` elements, where a psum of ``vals`` would carry twice that.
    The result equals that psum bit for bit (one nonzero row among zeros).
    On fake tensors (a dry-run) the rows a rank sends are the most it can
    hold, ``most_bound`` (its experts' slots), at placeholder positions."""
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import fake

    n, world = vals.shape[0], torch.distributed.get_world_size(group)
    if fake.is_fake(owner):
        idx = torch.full((world, min(n, most_bound)), n, dtype=torch.long, device=vals.device)
    else:
        counts = torch.bincount(owner, minlength=world + 1)[:world]
        most = int(counts.max())
        order = torch.argsort(owner, stable=True)  # each rank's slots, in order
        col = torch.arange(most, device=vals.device)
        starts = torch.cumsum(counts, 0) - counts
        idx = torch.where(col < counts[:, None],
                          order[(starts[:, None] + col).clamp(max=n - 1)],
                          n)  # [world, most], n: padding
    rows = coll.all_gather_rows(vals[idx[rank].clamp(max=n - 1)], group)
    out = vals.new_zeros((n + 1,) + tuple(vals.shape[1:])).index_copy(0, idx.reshape(-1), rows)
    return out[:n]


def moe_ffn_ep(x, params, mcfg: MoEConfig, mesh, daxes, n_data: int, n_model: int,
               x_summed: bool = False):
    """The JAX package's expert-parallel flow (GShard-style) on the rank at
    data index ``i`` (flattened over ``daxes``) and model index ``j``:

    1. **dispatch**: the rank routes its ``T/n_data`` tokens (capacity
       ``capacity(T/n_data)``: drops and ties are per data shard), keeps the
       slots of its ``E/n_model`` experts and fills their ``[E_loc·C_loc,
       D]`` input by one fill-mode gather — no collective;
    2. **expert compute**: the batched SwiGLU of its experts (a view of
       rows ``j·E_loc…`` of the stacked weights);
    3. **combine**: its slots read back by one clip-mode gather and
       gate-mixed, its own slots' rows gathered over ``model`` into place
       (:func:`_own_rows`: the EP combine's collective), then summed per
       token by the segment sum, and the data shards' rows gathered whole.
       JAX psums each rank's per-token partial ``[T/n_data, D]``, added in
       the input dtype; the port moves the weighted rows ``[T/n_data·k,
       D]`` (up to k/2× the bytes), so that each token's k rows are added
       in float32 and rounded once, as on one rank: expert-parallel output
       equals the one-rank output bit for bit at ``n_data`` 1. (A psum of
       each rank's float32 partial, rounded once, reorders the adds: on an
       H100 it moved deepseek-moe-16b's decode logits 5.3 % of max|logit|
       off the one-rank serve.)

    ``aux`` is the balance loss of each data shard, pmean'd over the data
    axes. ``x`` and the parameters are replicated inputs (each rank holds
    them whole): their gradients sum over the ranks — ``x``'s over the data
    axes only with ``x_summed``, where the caller sums it over ``model``
    (a tensor-parallel layer: ``x`` is the sequence gathered by its
    ``_enter``, whose backward reduce-scatters the model ranks' partial
    cotangents). Shared experts in ``params`` run whole on every rank over
    all tokens, as JAX runs them outside the region; a tensor-parallel
    layer leaves them out and runs them column- and row-split itself.
    Expert stacks of ``E/n_model`` experts (an FSDP state gathered over the
    data axes only) are this rank's own: taken as they are, their gradients
    summed over the data axes alone. Returns the replicated ``(y [T, D],
    aux)``.
    """
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd

    t, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    e_loc, t_loc = e // n_model, t // n_data
    cap_loc = capacity(t_loc, mcfg)
    world = shd.axis_group(mesh, tuple(daxes) + ("model",))
    g_data = shd.axis_group(mesh, daxes)
    g_model = shd.axis_group(mesh, ("model",))
    i = torch.distributed.get_rank(g_data) if n_data > 1 else 0
    j = torch.distributed.get_rank(g_model) if n_model > 1 else 0
    if x_summed:
        x_loc = (coll.copy_in(x, g_data) if n_data > 1 else x)[i * t_loc:(i + 1) * t_loc]
    else:
        x_loc = coll.copy_in(x, world)[i * t_loc:(i + 1) * t_loc]

    expert_idx, gate, aux = route(x_loc, coll.copy_in(params["router"], world), mcfg)
    pos, keep = dispatch_indices(expert_idx, e, cap_loc)
    moe_ffn.slots += keep.numel()
    moe_ffn.dropped = moe_ffn.dropped + (keep.numel() - keep.sum())
    e_local = expert_idx.reshape(-1) - j * e_loc  # [T_loc·k]
    mine = (e_local >= 0) & (e_local < e_loc) & keep
    n_slots = e_loc * cap_loc
    slot = torch.where(mine, e_local * cap_loc + pos, n_slots)
    dev = x.device
    token_id = torch.arange(t_loc, dtype=torch.int32, device=dev)[:, None].expand(
        t_loc, k).reshape(-1)
    if params["w1"].shape[0] == e_loc < e:  # this rank's own experts
        w1, w3, w2 = (coll.copy_in(params[w], g_data) if n_data > 1 else params[w]
                      for w in ("w1", "w3", "w2"))
    else:
        w1, w3, w2 = (coll.copy_in(params[w], world)[j * e_loc:(j + 1) * e_loc]
                      for w in ("w1", "w3", "w2"))
    expert_in = dispatch(x_loc, slot, token_id, n_slots).reshape(e_loc, cap_loc, d)
    out_slots = _experts(expert_in, w1, w3, w2)
    del expert_in

    vals = graph_ops.gather(out_slots, slot.clamp(max=n_slots - 1))  # [T_loc·k, D]
    del out_slots
    weight = (gate.reshape(-1) * mine).to(x.dtype)[:, None]
    vals = vals * weight if vals.requires_grad or weight.requires_grad else vals.mul_(weight)
    if n_model > 1:  # the EP combine
        owner = torch.where(keep, expert_idx.reshape(-1).long() // e_loc, n_model)
        vals = _own_rows(vals, owner, j, g_model, n_slots)
    offsets = torch.arange(0, k * (t_loc + 1), k, dtype=torch.int32, device=dev)
    y = graph_ops.segment_reduce(vals, token_id, t_loc, "sum", offsets=offsets)
    if n_data > 1:
        y = coll.all_gather_rows(y, g_data)
    # every rank holds its data shard's aux; JAX hands each rank the
    # replicated pmean's cotangent divided over all the ranks
    aux = coll.pmean(aux, g_data, 1.0 / (n_data * n_model))

    if "shared" in params:
        sh = params["shared"]
        y = y + common.swiglu(x, sh["w1"], sh["w3"], sh["w2"])
    return y, aux


moe_ffn.slots = 0
moe_ffn.dropped = 0
