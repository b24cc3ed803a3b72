"""Training entry point: config → data → step (loss and grads → cosine
schedule → AdamW) → the supervised loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --reduced --device cpu --steps 20 --batch 2 --seq 32 --log-every 5 \
        --ckpt-dir /tmp/ck --ckpt-every 10 --inject-failures 13
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --batch 4 --seq 4096 --steps 8                    # full width, on the card

The JAX package's ``repro.launch.train`` on the port: :func:`build` makes
the same three families' parameters, loss and batches (``token_batches``,
``gnn_full_batch``, ``recsys_batches``, each the JAX package's draws for a
seed), :func:`make_step` is its ``step_fn`` (``value_and_grad`` →
``cosine_schedule`` of the pre-step counter → ``adamw_update``, the
parameters and moments updated in place), and :class:`Supervised` runs it
under the ``TrainSupervisor`` (``ft.failures``, a copy of JAX's): async
atomic checkpoints in JAX's format every ``--ckpt-every`` steps, resume
from the newest, bounded retry that restores the last checkpoint and
replays, the straggler monitor, SIGTERM saves, and ``--inject-failures``
for drills. :func:`train` is that run (with ``ckpt_dir``) or a plain loop
(without). The parameters are random from ``--seed``, or the JAX
package's own (``build(..., params=...)``). Runs on ``--device cuda``
unless told otherwise; there the gradients of every kernel on the path are
the port's kernels (``kernels.autograd``).

Where JAX's step donates its buffers, the port's step updates the live
tensors in place. So the supervisor sees the state in the JAX nesting
(``{"params", "opt"}``, keyed as JAX's checkpoints) over the live tensors;
its ``init_state`` is a host copy of the initial state, and the step
loads whatever state it is handed — that host copy, or a checkpoint
restored to host memory — into the live tensors before it runs
(``copy_``; nothing when handed the live state itself), so a restore
makes no second copy of the state on the card.

On several ranks (a process group of ``world`` ranks: the JAX trainer's
``(world, 1)`` mesh) each rank runs the same step on its share of the
batch (:func:`data_parallel`): an LM's or AutoInt's rows split over the
ranks (loss and replicated gradients averaged over them in float32: JAX's
psum over the data axes), or a GNN's graph split over every rank as
``batch_shardings`` places it — each rank its block of the nodes and of
the edges — with the model on the mesh, whose loss and gradients are the
global ones already (the sums over the ranks' rows: nothing is averaged);
a batch the ranks do not divide is whole on every rank, the model on the
mesh. The live state is placed as JAX's ``main`` places it
(``param_shardings`` in ``fsdp`` mode, the moments like the parameters;
:func:`shard_state_`): each rank holds only its slice of every leaf the
rules split — the LM's matrices and embeddings over ``data`` — and the
whole of every other (norms, the router; GNN and AutoInt parameters are
``P()``). The model gathers a sharded leaf where it uses it, one layer at a
time (``dist.sharding.Gather``), and the gather's backward reduce-scatters
its gradient in float32 and averages it over the data ranks, so AdamW
updates each shard in place; the clipping norm is the whole gradient's.
The checkpoints hold whole arrays with the leaves' specs: the snapshot
gathers the shards into rank 0's host buffers, rank 0 writes, and a
restore hands each rank its slice. On a mesh with several ranks on its
model axis (``Supervised(..., mesh=)``) an LM, dense or MoE, runs
tensor-parallel over them (``models.transformer.model``; an MoE's routed
experts expert-parallel): each rank keeps its ``model`` block of every
leaf where it is — attention, FFN or shared experts, embeddings, expert
stacks — gathered over the data axes only, and the ranks of one data
shard hold its rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    _flatten,
    _unflatten,
    spec_json,
    tree_map,
)
from repro_torch.data.pipeline import gnn_full_batch, recsys_batches, token_batches
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.ft import FailureInjector, StragglerMonitor, TrainSupervisor
from repro_torch.graph.structure import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common
from repro_torch.models.gnn import models as gm
from repro_torch.models.recsys import autoint
from repro_torch.models.transformer import model as tm
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update_,
    cosine_schedule,
    named_leaves,
    opt_state_tree,
)

#: the families that train on a multi-rank mesh (all three)
MESH_FAMILIES = ("lm", "gnn", "recsys")


def make_train_mesh(device="cuda") -> shd.Mesh:
    """2-D ``(data, model)`` mesh over the process group's ranks (model=1:
    the live loop is data-parallel first). One process degrades to a 1×1
    mesh, so every sharding spec still resolves."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return make_mesh((world, 1), ("data", "model"), device=device)


def build(arch: str, reduced: bool, batch: int, seq: int, seed: int, device="cuda",
          params: Optional[Any] = None, config: Optional[Any] = None):
    """``(spec, cfg, params, loss_fn, batch_for_step)`` as the JAX ``build``:
    trainable parameters (random from ``seed``, or the JAX package's tree
    ``params`` of numpy arrays carried across), ``loss_fn(params, batch)``,
    and the batch of each step (16 LM or recsys batches in turn, or one
    full-graph batch). ``config`` stands in for the arch's (e.g. one cut
    to fewer layers)."""
    dev = resolve_device(device)
    spec = configs.get_spec(arch)
    cfg = config or (spec.reduced if reduced else spec.config)
    if spec.family == "lm":
        params = (tm.init(cfg, seed, dev, trainable=True) if params is None
                  else tm.params_from_arrays(cfg, params, dev, trainable=True))

        def loss_fn(p, b):
            return tm.loss_fn(p, b, cfg)

        data = token_batches(batch, seq, cfg.vocab_size, seed=seed, device=dev)
        batches = [next(data) for _ in range(16)]

        def batch_for_step(i):
            return batches[i % len(batches)]

    elif spec.family == "gnn":
        params = (common.trainable(gm.init(cfg, seed, dev)) if params is None
                  else gm.params_from_arrays(cfg, params, dev, trainable=True))

        def loss_fn(p, b):
            return gm.loss_fn(p, b, cfg)

        fb = gnn_full_batch(max(batch * 16, 64), 6.0, cfg.d_in, cfg.n_out, seed=seed,
                            task=cfg.task, n_out=cfg.n_out, device=dev)

        def batch_for_step(i):
            return fb

    else:
        params = (common.trainable(autoint.init(cfg, seed, dev)) if params is None
                  else autoint.params_from_arrays(cfg, params, dev, trainable=True))

        def loss_fn(p, b):
            return autoint.loss_fn(p, b, cfg)

        data = recsys_batches(batch, cfg.n_fields, cfg.vocab_per_field, seed=seed,
                              device=dev)
        batches = [next(data) for _ in range(16)]

        def batch_for_step(i):
            return batches[i % len(batches)]

    return spec, cfg, params, loss_fn, batch_for_step


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, {leaf name: gradient})``; a leaf the loss does not reach
    gets zeros, as JAX's ``value_and_grad`` gives it."""
    leaves = named_leaves(params)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(leaves.items(), grads)
    }


def accumulate(loss_fn: Callable, params, batch, micro: int):
    """``(loss, grads)`` over ``micro`` microbatches of ``batch``'s rows, as
    the JAX dry-run accumulates them: each microbatch's loss and gradient
    divided by ``micro`` and summed, bf16 leaves in bf16, others in f32."""
    rows = next(iter(batch.values())).shape[0] // micro
    loss, g = 0.0, None
    for i in range(micro):
        li, gi = value_and_grad(loss_fn, params,
                                {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})
        if g is None:
            g = {k: torch.zeros(v.shape, device=v.device, dtype=torch.bfloat16
                                if v.dtype == torch.bfloat16 else torch.float32)
                 for k, v in gi.items()}
        for k, v in gi.items():
            g[k].add_(v / micro)
        del gi
        loss = loss + li / micro
    return loss, g


def make_step(loss_fn: Callable, oc: AdamWConfig, warmup: int, total: int, group=None,
              micro: int = 1, shards: Optional["Shards"] = None):
    """The JAX ``step_fn``: ``step(state, batch) -> (state, {"loss"})`` with
    ``state = {"params", "opt"}``, both updated in place. With ``group``
    (:func:`data_parallel`'s) ``batch`` is this rank's share, and the loss
    and gradients are averaged over the group's ranks in float32 — but for
    the leaves whose gathers' backwards averaged them already (``shards``,
    :func:`shard_state_`, which also gives AdamW's clipping norm each
    shard's group, and the ZeRO-1 leaves their update of a slice). With
    ``micro`` > 1 the gradients are accumulated over that many microbatches
    (:func:`accumulate`; the dry-run's largest train cells)."""
    shards = shards or Shards()

    def step(state: Dict[str, Any], batch) -> tuple:
        p, o = state["params"], state["opt"]
        if micro == 1:
            loss, g = value_and_grad(loss_fn, p, batch)
        else:
            loss, g = accumulate(loss_fn, p, batch, micro)
        if group is not None:
            n = dist.get_world_size(group)
            loss = coll.psum(loss.float(), group) / n
            g = {k: v if k in shards.averaged else (coll.psum(v.float(), group) / n).to(v.dtype)
                 for k, v in g.items()}
        lr_scale = cosine_schedule(o["step"], warmup=warmup, total=total)
        if not shards.zero1:
            adamw_update_(p, g, o, oc, lr_scale=lr_scale, norm_groups=shards.norm_groups())
            return state, {"loss": loss}
        # ZeRO-1: a leaf's moments are a slice of its parameter; the rank
        # updates that slice (its gradient reduce-scattered onto it) and the
        # group's ranks gather the updated slices back into the parameter
        leaves, views = named_leaves(p), {}
        for k, (d, grp) in shards.zero1.items():
            n, r = dist.get_world_size(grp), dist.get_rank(grp)
            g[k] = (coll.reduce_scatter_dim(g[k].float(), d, grp) / n).to(g[k].dtype)
            rows = leaves[k].shape[d] // n
            views[k] = leaves[k].detach().narrow(d, r * rows, rows)
        adamw_update_({k: views.get(k, t) for k, t in leaves.items()}, g, o, oc,
                      lr_scale=lr_scale, norm_groups=shards.norm_groups())
        with torch.no_grad():
            for k, (d, grp) in shards.zero1.items():
                leaves[k].copy_(coll.all_gather_dim(views[k], d, grp))
        return state, {"loss": loss}

    return step


def batch_axes(family: str, mesh: shd.Mesh) -> Tuple[str, ...]:
    """The mesh axes a family's batch rows are split over
    (``batch_shardings``: an LM's over the data axes, AutoInt's and a
    GNN's over every axis)."""
    return {"lm": shd.data_axes(mesh), "recsys": shd.all_axes(mesh),
            "gnn": shd.all_axes(mesh)}[family]


def shard_graph(batch: Dict[str, torch.Tensor], mesh: shd.Mesh) -> Dict[str, torch.Tensor]:
    """A GNN batch placed by ``batch_shardings("gnn")``, leaf by leaf: a
    leaf whose rows (nodes, edges or graphs) the mesh's ranks divide as
    this rank's block of them (a flat DTensor over a view: no copy, no
    collective), any other whole."""
    bshard = shd.batch_shardings("gnn", batch, mesh)
    return {k: shd.shard_rows(v, mesh) if bshard[k].spec and bshard[k].spec[0] else v
            for k, v in batch.items()}


def data_parallel(family: str, batch_for_step: Callable, mesh: shd.Mesh):
    """How JAX's sharded step takes its batches on ``mesh``: ``(batch_for_step,
    group, on_mesh)``. On several ranks a GNN's batch is placed by
    ``batch_shardings`` (:func:`shard_graph`: each rank its block of every
    leaf the mesh divides) with the model on the mesh (``on_mesh``;
    ``group`` None: the model's loss and gradients are the global ones
    already, summed over the ranks' rows). An LM's or AutoInt's batch whose
    rows the ranks of :func:`batch_axes` divide is split over them: each
    rank's step sees its rows and averages over ``group``
    (:func:`make_step`); the model runs off the mesh unless the mesh has a
    model axis of several ranks (``on_mesh``: an LM's tensor parallelism,
    dense or MoE, the MoE's routed experts expert-parallel, over the rows
    the rank's data shard holds). Any other batch is whole on every rank
    and the model runs on the mesh (``on_mesh``; ``group`` None): an LM its
    heads over ``model`` and an MoE layer its tokens over the data axes (a
    data axis of one rank leaves the batch whole). On one rank each batch
    is placed on the mesh's device, on its 1×1 mesh."""
    if mesh.device_mesh is None:
        bshard = shd.batch_shardings(family, batch_for_step(0), mesh)
        return (lambda i: place(batch_for_step(i), bshard)), None, True
    if family not in MESH_FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if family == "gnn":
        return (lambda i: shard_graph(batch_for_step(i), mesh)), None, True
    axes = batch_axes(family, mesh)
    group = shd.axis_group(mesh, axes)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b = next(iter(batch_for_step(0).values())).shape[0]
    if b % n or n == 1:
        return batch_for_step, None, True
    rows = slice(r * b // n, (r + 1) * b // n)
    return ((lambda i: {k: v[rows] for k, v in batch_for_step(i).items()}), group,
            mesh.shape.get("model", 1) > 1)


def params_tree(params):
    """The parameters in the JAX nesting, over the live tensors."""
    return tm.params_tree(params) if isinstance(params, tm.TransformerParams) else params


def state_tree(params, opt: Dict[str, Any]) -> Dict[str, Any]:
    """The trainer's state in the JAX nesting, ``{"params", "opt"}``, over
    the live tensors (no copy): the tree the supervisor saves and restores,
    keyed as the JAX trainer's checkpoints."""
    tree = params_tree(params)
    return {"params": tree, "opt": opt_state_tree(params, tree, opt)}


def state_layout(family: str, params, mesh: shd.Mesh, mode: str = "fsdp"):
    """The state's placement as JAX's trainer places it, in the JAX nesting:
    the parameters by the family's rules in ``mode`` (``fsdp``; ``zero1``:
    over the model axis only), the moments always in ``fsdp`` mode, the
    step replicated."""
    tree = params_tree(params)
    oshard = shd.param_shardings(family, tree, mesh)
    pshard = oshard if mode == "fsdp" else shd.param_shardings(family, tree, mesh, mode)
    return {"params": pshard, "opt": {"m": oshard, "v": oshard,
                                      "step": shd.replicated(None, mesh)}}


@dataclasses.dataclass
class Shards:
    """The leaves this rank holds as slices (:func:`shard_state_`), by
    ``named_leaves``' names: ``params`` and ``opt`` each leaf's sharding
    (the parameter's, its moments'); ``averaged`` the leaves whose
    gradients the gathers' backwards average over the batch's ranks;
    ``zero1`` the leaves whose moments are a slice of the parameter:
    ``(dimension, process group)`` of that slice."""

    params: Dict[str, shd.NamedSharding] = dataclasses.field(default_factory=dict)
    opt: Dict[str, shd.NamedSharding] = dataclasses.field(default_factory=dict)
    averaged: frozenset = frozenset()
    zero1: Dict[str, Tuple[int, Any]] = dataclasses.field(default_factory=dict)

    def norm_groups(self) -> Dict[str, Any]:
        """Each sharded gradient's process group over the axes its parts lie
        on (the moments' layout): where AdamW's clipping norm sums them."""
        return {k: shd.axis_group(sh.mesh, {a for _, axes in shd.sharded_dims(sh)
                                            for a in axes})
                for k, sh in self.opt.items()}


@torch.no_grad()
def shard_state_(params, opt: Optional[Dict[str, Any]], layout,
                 axes: Sequence[str] = ()) -> Shards:
    """Hold every leaf that ``layout`` (:func:`state_layout`) splits over
    more than one rank as this rank's slice of it — the parameter (gathered
    where the model uses it, the batch split over ``axes``) and its two
    moments in ``opt``, if given — releasing the whole. An LM that runs
    tensor-parallel (``models.transformer.model.tensor_parallel``: dense or
    MoE) gathers each leaf over the data axes only: the rank uses its
    ``model`` block where it is (an MoE's expert stacks its ``E/m``
    experts, which ``moe_ffn_ep`` computes).
    Returns the :class:`Shards` (empty on one rank, or where the rules give
    ``P()``)."""
    if layout["opt"]["step"].mesh.device_mesh is None:
        return Shards()
    leaves = named_leaves(params)
    name_of = {id(t): k for k, t in leaves.items()}
    names = [name_of[id(t)] for _, t in _flatten(params_tree(params))]
    psplit = {k: sh for k, (_, sh) in zip(names, _flatten(layout["params"]))
              if shd.sharded_dims(sh)}
    osplit = {k: sh for k, (_, sh) in zip(names, _flatten(layout["opt"]["m"]))
              if shd.sharded_dims(sh)}
    if not osplit:
        return Shards()
    if not isinstance(params, tm.TransformerParams):
        raise NotImplementedError("FSDP shards of a family other than the LM's")
    keep = ("model",) if tm.tensor_parallel(layout["opt"]["step"].mesh) else ()
    gathers = {k: shd.Gather.of(sh, axes, keep) for k, sh in psplit.items()}
    averaged = set()
    for k, gather in gathers.items():
        means = {a for d, _, mean in gather.dims if mean
                 for a in dict(shd.sharded_dims(psplit[k]))[d]}
        if means and means != set(axes):
            raise NotImplementedError(f"{k}: split over part of the batch axes {axes}")
        averaged |= {k} if means else set()
    zero1 = {}
    for k, sh in osplit.items():
        held = {(d, a) for d, names_ in shd.sharded_dims(psplit[k]) for a in names_} \
            if k in psplit else set()
        extra = [(d, tuple(a for a in names_ if (d, a) not in held))
                 for d, names_ in shd.sharded_dims(sh)]
        extra = [(d, names_) for d, names_ in extra if names_]
        if not extra:
            continue
        if len(extra) > 1 or set(extra[0][1]) != set(axes):
            raise NotImplementedError(f"{k}: moments split past the parameter off the batch axes")
        zero1[k] = (extra[0][0], shd.axis_group(sh.mesh, extra[0][1]))
        averaged.add(k)  # its slice's reduce-scatter averages it

    def cut(t, sh):
        return shd.shard_of(t.detach(), sh).clone(memory_format=torch.contiguous_format)

    params.shard_({k: cut(leaves[k], sh) for k, sh in psplit.items()}, gathers)
    for part in ("m", "v") if opt is not None else ():
        opt[part].update({k: cut(opt[part][k], sh) for k, sh in osplit.items()})
    return Shards(params=psplit, opt=osplit, averaged=frozenset(averaged), zero1=zero1)


def host_copy(tree):
    """A copy of every leaf in host memory."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def place(tree, shardings):
    """Every leaf of ``tree`` placed by its sharding (``dist.sharding.
    device_put``; on one rank, moved to the mesh's device)."""
    placed = [shd.device_put(t, sh) for (_, t), (_, sh) in zip(_flatten(tree),
                                                                _flatten(shardings))]
    return _unflatten(tree, iter(placed))


class Supervised:
    """The JAX trainer's ``main`` loop: the step of :func:`make_step` over
    ``params`` (and ``opt_state``, else zeros) under a ``TrainSupervisor``
    checkpointing to ``ckpt_dir``, on ``mesh`` (by default
    :func:`make_train_mesh`'s) with the batches of :func:`data_parallel`. ``total`` is the schedule's length and
    :meth:`run`'s ``n_steps`` where the run stops (a job cut short runs to
    fewer steps than its schedule). ``losses`` collects ``(step index,
    loss)`` of every step run, replays included; ``sup`` is the supervisor
    (its ``retries``, ``restarts`` and ``straggler.events``)."""

    def __init__(self, family: str, params, loss_fn: Callable, batch_for_step: Callable,
                 oc: AdamWConfig, *, warmup: int, total: int, ckpt_dir: str,
                 ckpt_every: int = 50, inject_failures: Sequence[int] = (),
                 opt_state: Optional[Dict[str, Any]] = None, log_every: int = 10,
                 log=print, device="cuda", mesh: Optional[shd.Mesh] = None):
        self.params = params
        self.mesh = mesh or make_train_mesh(device)
        batches, group, self.on_mesh = data_parallel(family, batch_for_step, self.mesh)
        self.batch_split = group is not None
        dev = resolve_device(self.mesh.device)
        if any(t.to(dev) is not t for t in named_leaves(params).values()):  # itself if there
            raise ValueError(f"the state is not on the mesh's device {dev}")
        # the state placed as JAX places it: each rank keeps its FSDP shards
        # (the moments made on them when none are given)
        self.layout = state_layout(family, params, self.mesh)
        self.shards = shard_state_(params, opt_state, self.layout,
                                   () if group is None else batch_axes(family, self.mesh))
        self.opt = opt_state or adamw_init(params, oc)
        multi = self.mesh.device_mesh is not None
        flat_layout = dict(_flatten(self.layout))
        self._view = None
        # the step updates the live tensors in place, so the supervisor's
        # restore-and-replay template must be durable: a host copy (of the
        # shards)
        self.init_state = host_copy(state_tree(params, self.opt))
        self.losses: List[Tuple[int, float]] = []
        self.log, self.log_every = log, log_every
        self._step = make_step(loss_fn, oc, warmup, total, group, shards=self.shards)
        self._last = time.perf_counter()
        self.sup = TrainSupervisor(
            self._wrapped_step,
            batches,
            ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every,
            injector=FailureInjector(list(inject_failures)) if inject_failures else None,
            straggler=StragglerMonitor(),
            on_straggler=lambda ev: log(f"[straggler] {ev}"),
        )
        #: flat key → sharding of each state leaf held as this rank's slice
        self.shardings = {k: sh for k, sh in flat_layout.items() if shd.sharded_dims(sh)}
        self.sup.ckpt = AsyncCheckpointer(
            ckpt_dir, specs={k: spec_json(sh.spec) for k, sh in flat_layout.items()}
            if multi else None, shards=self.shardings if multi else None)

    def tree(self) -> Dict[str, Any]:
        """The live state in the JAX nesting (what the step hands back)."""
        self._view = state_tree(self.params, self.opt)
        return self._view

    def state_bytes(self) -> int:
        """Bytes of the live parameters and moments this rank holds."""
        return sum(t.numel() * t.element_size() for _, t in _flatten(self.tree()))

    @torch.no_grad()
    def load_(self, state):
        """Copy ``state`` (in the JAX nesting: a host copy of the shards, or
        a restored checkpoint's whole leaves, of which this rank takes its
        slice) into the live tensors; nothing if it is the live state."""
        if state is self._view:
            return
        for (k, dst), (k2, src) in zip(_flatten(self.tree()), _flatten(state)):
            if k != k2:
                raise KeyError(f"state leaf {k2!r} where {k!r} was expected")
            if k in self.shardings and src.shape != dst.shape:
                src = shd.shard_of(src, self.shardings[k])
            dst.copy_(src)

    def _wrapped_step(self, state, batch):
        self.load_(state)
        _, metrics = self._step({"params": self.params, "opt": self.opt}, batch)
        s = int(self.opt["step"])
        loss = float(metrics["loss"])
        self.losses.append((s - 1, loss))
        if s % self.log_every == 0:
            now = time.perf_counter()
            self.log(f"step {s:5d} loss {loss:.4f} "
                     f"({now - self._last:.2f}s/{self.log_every} steps)")
            self._last = now
        return self.tree(), metrics

    def run(self, n_steps: int):
        """Train to ``n_steps`` (resuming from the newest checkpoint); the
        live tensors then hold the final state. Returns ``(step,
        metrics)``; ``metrics`` is ``None`` when no step ran. The
        supervisor's SIGTERM handler (which holds it, and through it the
        whole training state) is replaced by the one from before the run
        when the run ends."""
        if self.on_mesh:
            shd.activate(self.mesh, batch_split=self.batch_split)
        sigterm = signal.getsignal(signal.SIGTERM)
        try:
            state, step, metrics = self.sup.run(self.init_state, n_steps)
        finally:
            shd.deactivate()
            # None: a handler not installed from Python; off the main thread
            # the supervisor installs none
            if sigterm is not None and signal.getsignal(signal.SIGTERM) is not sigterm:
                signal.signal(signal.SIGTERM, sigterm)
        self.load_(state)
        return step, metrics


def train(arch: str, reduced: bool = False, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, warmup: int = 20, seed: int = 0,
          device="cuda", log_every: int = 10, params: Optional[Any] = None,
          opt_state: Optional[Dict[str, Any]] = None, log=print,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          inject_failures: Sequence[int] = ()) -> List[float]:
    """``steps`` steps of :func:`make_step`'s step (AdamW state
    ``opt_state`` or zeros); prints the JAX trainer's ``step … loss …``
    line every ``log_every`` steps and its ``done at step N: loss=…`` line.
    With ``ckpt_dir`` the run is :class:`Supervised` (resumed from the
    newest checkpoint there, ``inject_failures`` the 0-based steps that fail
    once) and the ``done`` line adds the retries, restarts and stragglers;
    without, a plain loop from step 0. Returns the loss of every step run,
    replays included, in order."""
    spec, _, p, loss_fn, batch_for_step = build(arch, reduced, batch, seq, seed, device,
                                                params)
    oc = AdamWConfig(lr=lr)
    if ckpt_dir is not None:
        run = Supervised(spec.family, p, loss_fn, batch_for_step, oc, warmup=warmup,
                         total=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                         inject_failures=inject_failures, opt_state=opt_state,
                         log_every=log_every, log=log, device=device)
        step, metrics = run.run(steps)
        loss = float("nan") if metrics is None else float(metrics["loss"])
        sup = run.sup
        log(f"done at step {step}: loss={loss:.4f} retries={sup.retries} "
            f"restarts={sup.restarts} stragglers={len(sup.straggler.events)}")
        return [x for _, x in run.losses]
    mesh = make_train_mesh(device)
    batches, group, on_mesh = data_parallel(spec.family, batch_for_step, mesh)
    shards = shard_state_(p, opt_state, state_layout(spec.family, p, mesh),
                          () if group is None else batch_axes(spec.family, mesh))
    state = {"params": p, "opt": opt_state or adamw_init(p, oc)}
    step_fn = make_step(loss_fn, oc, warmup, steps, group, shards=shards)
    losses: List[float] = []
    last = time.perf_counter()
    if on_mesh:
        shd.activate(mesh, batch_split=group is not None)
    try:
        for i in range(steps):
            state, metrics = step_fn(state, batches(i))
            losses.append(float(metrics["loss"]))
            s = int(state["opt"]["step"])
            if s % log_every == 0:
                now = time.perf_counter()
                log(f"step {s:5d} loss {losses[-1]:.4f} "
                    f"({now - last:.2f}s/{log_every} steps)")
                last = now
    finally:
        shd.deactivate()
    log(f"done at step {int(state['opt']['step'])}: loss={losses[-1]:.4f}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    # the JAX trainer's /tmp/repro_ckpt, under $TMPDIR where it is set
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated step indices to fail at (drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.arch, args.reduced, args.steps, args.batch, args.seq, args.lr,
          args.warmup, args.seed, args.device, args.log_every,
          log=lambda line: print(line, flush=True), ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every,
          inject_failures=[int(x) for x in args.inject_failures.split(",") if x])


if __name__ == "__main__":
    main()
