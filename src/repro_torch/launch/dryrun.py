"""Dry-run: trace every (arch × shape) cell's step, a rank's, nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \
        --shape prefill_32k --mesh both --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --palgol-partition \
        --shards 8 --graph-scale 10

The JAX package's ``repro.launch.dryrun`` on the port, on the ``card``
mesh (one H100) and on the JAX package's pod meshes, ``single`` (16 × 16,
``("data", "model")``) and ``multi`` (2 × 16 × 16, ``("pod", "data",
"model")``), one H100 a rank. For each cell it builds fake parameters and
batches (``abstract_params``/``input_specs``: shapes and dtypes, no
memory), places them as rank 0 of the mesh holds them, and runs the port's
own step on them under ``FakeTensorMode`` — the trainer's ``make_step``
(loss, gradients, cosine schedule, AdamW in place) with JAX's microbatch
accumulation, ``prefill``/``decode_step_``, AutoInt's
``forward``/``retrieval_score``, the GNN step of ``gnn_cell`` — and
records:

* ``memory``: the bytes of the step's arguments (parameters, optimiser
  state, batch, cache) and of its outputs, of which ``alias`` are
  arguments updated in place (the parameters and moments a train step
  returns, a decode step's cache: JAX's donated buffers), and the peak of
  live storage over the step as the trace allocates and frees it
  (``temp`` = peak − arguments − outputs + alias, JAX's identity);
  ``fits`` is the peak against :class:`HW`'s ``hbm_bytes``;
* ``cost``: PyTorch ops' flops (``torch.utils.flop_counter``) plus each
  kernel's bound flops, and bytes — every other op reading its inputs and
  writing its outputs once (no fusion; views read nothing), plus each
  kernel's bound bytes (``kernels.fake``);
* ``launches``: the kernel launches per route, counted by the wrappers'
  own counters on their fake route; ``collectives``, a rank's wire bytes,
  from ``dist.collectives.COUNTS`` (none on one card); ``roofline`` and
  ``model_flops`` as JAX's.

On a pod mesh the trace is rank 0's, in a fake process group of the
mesh's 256 or 512 ranks (torch's ``"fake"`` backend: each collective
returns at once and moves nothing; ``COUNTS`` records what it would move).
The rank holds its shard of the state as the trainer does
(``launch.train.shard_state_``), by ``PARAM_MODE`` — ``fsdp``, or ``zero1``
for the three dense ``train_4k`` cells (parameters over the model axis
only, moments in ``fsdp``, each rank updating its slice) — and its share
of the batch (``launch.train.batch_axes``: an LM's rows over the data
axes, AutoInt's over every axis; a batch they do not divide whole, with
the model on the mesh). A GNN's graph is split over every rank as
``batch_shardings("gnn")`` places it: the rank holds its block of every
leaf whose rows the mesh divides (nodes, edges), the others whole, and
the model keeps node and edge activations split likewise between its
layers (``models.gnn.models``), gathering node state whole only at a
region's entry. An LM, dense or MoE, runs
tensor- and sequence-parallel over the model axis, as JAX's specs lay it
out (``models.transformer.model``): the rank uses its ``model`` block of
every weight (gathered over the data axes only), computes its query heads,
its ``d_ff/m`` (an MoE's ``shared_ff/m``) columns, its ``V/m`` logits and
its block of the sequence, and holds its ``C/m`` slots of a cache
(``lm_cache_spec``; a decode cell's cache argument is that block). An
MoE's routed experts are split over the model axis, each rank computing
its own over its data shard's tokens (``moe_ffn_ep``), as JAX's expert
parallelism does. So ``flops_per_device`` is the rank's own share — JAX's
divided by the model axis, but for the heads that JAX's ``_maybe`` holds
whole (qwen2.5-32b's 40 query heads on 16 ranks, which every rank then
attends with; the record's ``tp`` says which).

A Python layer loop is traced whole, every layer and every microbatch, so
JAX's corrections for XLA have no counterpart here: the scan probe (XLA's
cost analysis counts a loop body once) and the f32 shadow (XLA:CPU's f32
copies of bf16 operands). A cell that does not fit gives ``status: "ok"``
with ``fits: false``; a cell the arch skips gives ``status: "skipped"``.

``--device cuda`` (the default) traces fake CUDA tensors and reads the
card's memory size; ``--device cpu`` runs on a host without a card, with
the tensors naming the CPU (a CPU-only PyTorch build's autograd cannot
hold fake CUDA tensors) and the datasheet's 80 GB. Either way every kernel
wrapper takes its fake route, whose routing is the card's. Records land in
``experiments/dryrun/card/<arch>__<shape>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

import torch.distributed as dist

from repro_torch import configs
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.kernels import fake
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import batch_axes, make_step, shard_state_, state_layout
from repro_torch.models import common
from repro_torch.models.gnn import models as gm
from repro_torch.models.recsys import autoint
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer import moe as moe_mod
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.roofline.analysis import HW, collective_bytes_from_counts, roofline_terms

OUT_DIR = Path("experiments/dryrun")

#: gradient-accumulation microbatches per (arch, shape), as the JAX
#: package's: the global batch is unchanged, activations scale 1/M
MICROBATCH = {
    ("qwen3-moe-235b-a22b", "train_4k"): 8,
    ("qwen3-32b", "train_4k"): 2,
    ("qwen2.5-32b", "train_4k"): 2,
    ("deepseek-moe-16b", "train_4k"): 2,
}

#: the JAX package's parameter layout per train cell ("zero1": parameters
#: sharded over the model axis only, the moments in "fsdp"; every other
#: cell "fsdp"). On the card's one rank every layout holds the whole state.
PARAM_MODE = {
    ("qwen3-32b", "train_4k"): "zero1",
    ("qwen2.5-32b", "train_4k"): "zero1",
    ("h2o-danube-1.8b", "train_4k"): "zero1",
}

#: the trainer's schedule defaults (``launch.train``), for the traced step
WARMUP, TOTAL = 20, 100

#: the meshes: shape and axes (the pod meshes are the JAX package's
#: ``make_production_mesh``); ``card`` is one H100
MESHES = {"card": ((1,), ("data",)), "single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

#: ops that read and write no tensor data: factories of uninitialised
#: memory, and views that the schema does not mark as views
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh",
               "_unsafe_view", "set_", "resize_")


# ---------------------------------------------------------------------------
# the tracer


def _wrappers():
    """The seven kernel wrappers, whose ``launches*`` attributes count."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd

    return (kernels.gather_rows, kernels.segment_reduce, kernels.flash_attention,
            kernels.embedding_bag, flash_attention_bwd, kernels.scatter_rows,
            kernels.segment_reduce_bwd)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counters, ``"<wrapper>.<counter>"``."""
    return {f"{fn.__name__}.{key}": value for fn in _wrappers()
            for key, value in vars(fn).items() if key.startswith("launches")}


def _set_counts(counts: Dict[str, int]) -> None:
    """Sets every counter that :func:`launch_counts` reads to ``counts``'."""
    by_name = {fn.__name__: fn for fn in _wrappers()}
    for key, value in counts.items():
        name, counter = key.split(".")
        setattr(by_name[name], counter, value)


def launches_between(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """``{kernel: {route: n}}`` of the launches between two
    :func:`launch_counts` (``"all"`` every route), kernels with none left out."""
    out: Dict[str, Dict[str, int]] = {}
    for key, value in after.items():
        n = value - before.get(key, 0)
        name, counter = key.split(".")
        if n:
            out.setdefault(name, {})[counter[len("launches_"):] or "all"] = n
    return out


class _Traffic(TorchDispatchMode):
    """Live storage over the trace (each storage counted once, from the op
    that makes it until it is freed) and its peak; and the bytes each op
    that makes a tensor reads and writes (views, :data:`_NO_TRAFFIC` and
    metadata queries such as ``.device`` excepted)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.bytes = 0
        self.sizes: Dict[int, int] = {}
        self.closed = False

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.sizes:
            return
        self.sizes[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        if not self.closed:
            self.live -= self.sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [_local(t) for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if outs and not func.is_view and func.__name__.split(".")[0] not in _NO_TRAFFIC:
            ins = [_local(t) for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += fake.nbytes(*ins, *outs)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """The rank's own tensor of a DTensor (whose op this mode sees; its
    local op it does not), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _storages(tree) -> Dict[int, int]:
    """``{storage: bytes}`` of every tensor leaf of ``tree``."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _leaves(tree):
    """Tensor leaves of a tree, a module's parameters included."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **kwargs) -> int:
    """``bmm``'s flops, its ``out_dtype`` overload too (torch's own formula
    takes that overload's dtype argument for the output's shape)."""
    b, m, k = a_shape
    return b * m * b_shape[-1] * 2 * k


def trace(fn: Callable, args: Tuple, hw: Optional[HW] = None, n_devices: int = 1,
          model_flops: Optional[float] = None) -> Dict[str, Any]:
    """Runs ``fn(*args)`` on fake tensors (``args`` from ``abstract_params``
    /``input_specs``, or :func:`fake_like`) and returns its ``memory``,
    ``cost``, ``launches``, ``kernels`` (each kernel's bound work),
    ``collectives`` and ``roofline`` (see module). The kernels' fake
    launches advance their wrappers' counters as launches would, and the
    launches are read from them; afterwards every counter is set back to
    what it was (and ``moe_ffn``'s slot counters), so a trace between a
    path's reads of its counters leaves them as the card's launches made
    them."""
    hw = hw or HW()
    arg_storage = _storages(_leaves(args))
    moe_counts = (moe_mod.moe_ffn.slots, moe_mod.moe_ffn.dropped)
    moe_mod.moe_ffn.slots, moe_mod.moe_ffn.dropped = 0, 0  # a device tensor once used
    fake.reset()
    coll.reset_counts()
    before = launch_counts()
    traffic = _Traffic()
    for t in _leaves(args):
        traffic.track(t)
    t0 = time.perf_counter()
    try:
        with common.fake_mode(_leaves(args)), FlopCounterMode(
                display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flop}) as flops, traffic:
            out = fn(*args)
        launches = launches_between(before, launch_counts())
    finally:
        moe_mod.moe_ffn.slots, moe_mod.moe_ffn.dropped = moe_counts
        _set_counts(before)
    seconds = time.perf_counter() - t0
    peak = traffic.peak
    traffic.closed = True
    out_storage = _storages(_leaves(out))
    alias = sum(n for k, n in out_storage.items() if k in arg_storage)
    output = sum(out_storage.values())
    argument = sum(arg_storage.values())
    kernel_flops = sum(w["flops"] for w in fake.WORK.values())
    kernel_bytes = sum(w["bytes"] for w in fake.WORK.values())
    flops_dev = float(flops.get_total_flops()) + kernel_flops
    bytes_dev = float(traffic.bytes) + kernel_bytes
    collectives = collective_bytes_from_counts(coll.reset_counts(), n_devices)
    return {
        "trace_s": seconds,
        "memory": {
            "argument_bytes": argument,
            "output_bytes": output,
            "temp_bytes": peak - argument - output + alias,
            "alias_bytes": alias,
            "peak_per_device_bytes": peak,
            "fits": bool(peak < hw.hbm_bytes),
            "hbm_bytes": hw.hbm_bytes,
        },
        "cost": {
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "kernel_flops_per_device": kernel_flops,
            "kernel_bytes_per_device": kernel_bytes,
        },
        "launches": launches,
        "kernels": {k: dict(v) for k, v in fake.WORK.items()},
        "collectives": collectives,
        "roofline": roofline_terms(flops_dev, bytes_dev, collectives["total"], n_devices,
                                   hw, model_flops),
    }


def fake_like(tree, device=None):
    """A fake twin of a tree of real tensors (same nesting, shapes, dtypes,
    ``requires_grad``; a ``TransformerParams`` rebuilt), on ``device`` or
    each tensor's own: what :func:`trace` takes to dry-run a step that also
    runs for real."""
    mode = common.fake_mode()

    def twin(t):
        with mode:
            out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                      device=device or t.device)
        return out.requires_grad_(t.requires_grad)

    return common.map_tensors(tree, twin)


# ---------------------------------------------------------------------------
# per-family steps


def train_step(loss_fn: Callable, oc: AdamWConfig, micro: int = 1,
               warmup: int = WARMUP, total: int = TOTAL, **placement) -> Callable:
    """``step(params, opt, batch) -> (params, opt, loss)``, the first two
    updated in place: ``launch.train.make_step`` (loss and gradients, with
    ``micro`` microbatches accumulated as the JAX dry-run accumulates them;
    the cosine schedule of the pre-step counter; AdamW in place); on a mesh
    ``placement`` is the rank's ``group`` and ``shards`` (:class:`Rank`)."""
    step = make_step(loss_fn, oc, warmup, total, micro=micro, **placement)

    def fn(p, o, batch):
        _, metrics = step({"params": p, "opt": o}, batch)
        return p, o, metrics["loss"]

    return fn


@contextlib.contextmanager
def fake_ranks(shape, axes, device="cuda"):
    """This process as rank 0 of a fake process group of ``prod(shape)``
    ranks (torch's ``"fake"`` backend: every collective returns at once and
    moves nothing), and the mesh over it; one rank is the one-rank mesh,
    with no group. The group is destroyed on exit."""
    size = math.prod(shape)
    if size == 1:
        yield make_mesh(shape, axes, device)
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("a rank's dry-run needs its own process group; one exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        mesh = make_mesh(shape, axes, device)
        shd.flat_mesh(mesh)  # made here, off the fake mode: a DeviceMesh reads its ranks
        yield mesh
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Rank:
    """A rank's place in a cell: its ``mesh`` (``None``: the card, one
    rank), its ``rows`` of the batch, the ``group`` over which its step
    averages (``None``: nothing averaged, the model on the mesh — the batch
    whole, or a GNN's split leaf by leaf by :func:`gnn_cell`) and the
    batch ``axes`` it is split over."""

    mesh: Optional[shd.Mesh]
    rows: int
    group: Any = None
    axes: Tuple[str, ...] = ()

    @classmethod
    def of(cls, family: str, batch: int, mesh: Optional[shd.Mesh]) -> "Rank":
        """The trainer's rule (``launch.train.data_parallel``): the batch's
        rows split over the family's batch axes when they divide it (a
        GNN's placed by :func:`gnn_cell`)."""
        if mesh is None or mesh.size == 1:
            return cls(None, batch)
        axes = batch_axes(family, mesh)
        n = math.prod(mesh.shape[a] for a in axes)
        if family == "gnn" or batch % n or n == 1:
            # a GNN's batch is split leaf by leaf (gnn_cell), its model on
            # the mesh and its loss the global one: nothing to average
            return cls(mesh, batch)
        return cls(mesh, batch // n, shd.axis_group(mesh, axes), axes)

    def place(self, family: str, params, opt=None, mode: str = "fsdp"):
        """Holds ``params`` and ``opt`` (fake, whole) as the rank's shards
        (an LM's ``model`` blocks kept where it runs tensor-parallel);
        returns the ``launch.train.Shards``."""
        if self.mesh is None:
            return None
        return shard_state_(params, opt, state_layout(family, params, self.mesh, mode),
                            self.axes)

    def run(self, fn: Callable) -> Callable:
        """``fn`` under the mesh when the model runs on it: the batch whole
        or a GNN's graph split leaf by leaf, or an LM's split over the data
        axes with a model axis to split the heads and the experts
        (``models.transformer.model.tensor_parallel``)."""
        if self.mesh is None or not (self.group is None or tm.tensor_parallel(self.mesh)):
            return fn

        def on_mesh(*args):
            shd.activate(self.mesh, batch_split=self.group is not None)
            try:
                return fn(*args)
            finally:
                shd.deactivate()

        return on_mesh


def lm_cell(spec, shape_id: str, shape: Dict, device="cuda", cfg=None, mesh=None):
    """``(fn, args, model_flops)`` of an LM cell: the train step, a prefill
    (last-position logits only) or a decode step, of rank 0 of ``mesh``
    (``None``: the card)."""
    cfg = cfg or spec.config
    kind = shape["kind"]
    seq, batch = shape["seq_len"], shape["global_batch"]
    rank = Rank.of("lm", batch, mesh)
    if kind == "train":
        params = tm.abstract_params(cfg, device, trainable=True)
        oc = AdamWConfig(state_dtype="bfloat16" if cfg.n_params() > 1e11 else None)
        with common.fake_mode():
            opt = adamw_init(params, oc)
        shards = rank.place("lm", params, opt, PARAM_MODE.get((spec.arch_id, shape_id), "fsdp"))
        micro = MICROBATCH.get((spec.arch_id, shape_id), 1)
        fn = train_step(lambda p, b: tm.loss_fn(p, b, cfg), oc, micro, group=rank.group,
                        shards=shards)
        args = (params, opt, tm.input_specs(cfg, "train", seq, rank.rows, device))
    elif kind == "prefill":
        params = tm.abstract_params(cfg, device)
        rank.place("lm", params)

        def fn(p, b):
            return tm.prefill(p, b["tokens"], cfg, full_logits=False)

        args = (params, tm.input_specs(cfg, "prefill", seq, rank.rows, device))
    elif kind == "decode":
        params = tm.abstract_params(cfg, device)
        rank.place("lm", params)
        specs = tm.input_specs(cfg, "decode", seq, rank.rows, device)
        if tm.tensor_parallel(mesh):  # the rank's C/m slots of the cache
            kv = specs["cache"]["k"]
            block = shd.shard_shape(kv.shape, shd.NamedSharding(mesh, shd.lm_cache_spec(
                mesh, cfg, kv.shape[1], kv.shape[2])))
            if block[2] == kv.shape[2]:
                raise NotImplementedError(f"a cache of {kv.shape[2]} slots the model axis "
                                          f"does not divide")
            specs["cache"]["k"], specs["cache"]["v"] = (
                common.fake_tensor(kv.shape[:2] + block[2:], kv.dtype, device)
                for _ in range(2))

        def fn(p, cache, toks):  # the cache updated in place, as JAX's donated one
            return tm.decode_step_(p, cache, toks, cfg), cache

        args = (params, specs["cache"], specs["tokens"])
    else:
        raise ValueError(kind)
    return rank.run(fn), args, lm_model_flops(cfg, shape)


def lm_model_flops(cfg, shape: Dict) -> float:
    """The JAX dry-run's model flops of an LM cell: 6·N_active·tokens a
    train step, 2·N_active·tokens a prefill, a decode step's weight read
    plus its KV attention."""
    seq, batch = shape["seq_len"], shape["global_batch"]
    if shape["kind"] == "train":
        return 6.0 * cfg.n_active_params() * batch * seq
    if shape["kind"] == "prefill":
        return 2.0 * cfg.n_active_params() * batch * seq
    cache_c = tm.cache_len(cfg, seq)
    kv_flops = 2.0 * batch * cfg.n_layers * cfg.n_heads * cache_c * cfg.head_dim * 2
    return 2.0 * cfg.n_active_params() * batch + kv_flops


def _pad1024(n: int) -> int:
    """Graph arrays padded to a multiple of 1024 rows, as the JAX dry-run
    pads them (padding edges are the sentinel rows of the batch layout)."""
    return -(-n // 1024) * 1024


def gnn_graph_size(shape: Dict) -> Tuple[int, int]:
    """``(nodes, edges)`` of a GNN cell's batch graph: a full graph padded
    to multiples of 1024 rows, the sampled minibatch as a block graph of
    its seeds and two hops, or a batch of small graphs as one."""
    kind = shape["kind"]
    if kind == "full_graph":
        return _pad1024(shape["n_nodes"]), _pad1024(shape["n_edges"])
    if kind == "minibatch":
        b = shape["batch_nodes"]
        f0, f1 = shape["fanouts"]
        return b * (1 + f0 + f0 * f1), b * (f0 + f0 * f1)
    return shape["batch"] * shape["n_nodes"], shape["batch"] * shape["n_edges"]


def gnn_cell(spec, shape_id: str, shape: Dict, device="cuda", mesh=None):
    """``(fn, args, model_flops)`` of a GNN cell: the train step on the
    batch graph of :func:`gnn_graph_size` (JAX's ``gnn_cell``); on a mesh
    the rank's block of every batch leaf whose rows the mesh divides
    (``batch_shardings("gnn")``, as ``launch.train.shard_graph`` places it;
    the others whole), with the model on the mesh."""
    cfg = configs.resolve_gnn_config(spec.config, shape_id, shape)
    n, e = gnn_graph_size(shape)
    if shape["kind"] == "batched_graphs":
        batch_specs = gm.input_specs(cfg, "batched_graphs", device, batch=shape["batch"],
                                     n_nodes=shape["n_nodes"], n_edges=shape["n_edges"],
                                     d_feat=shape["d_feat"])
        if mesh is not None and n % mesh.size:
            # the fused PNA and GraphCast layers scatter the node rows over
            # every rank (JAX's tiled psum_scatter), which 3,840 nodes do not
            # divide on 512 ranks: JAX's own dry-run fails there. The port
            # pads the nodes to whole 1,024-row blocks, as JAX pads a full
            # graph; a padding node has no edge and the sentinel graph id
            x, gid = batch_specs["x"], batch_specs["graph_id"]
            batch_specs["x"] = common.fake_tensor((_pad1024(n),) + tuple(x.shape[1:]),
                                                  x.dtype, device)
            batch_specs["graph_id"] = common.fake_tensor((_pad1024(n),), gid.dtype, device)
    else:
        batch_specs = gm.input_specs(cfg, "full_graph", device, n_nodes=n, n_edges=e,
                                     d_feat=shape["d_feat"])
    params = common.trainable(gm.abstract_params(cfg, device))
    oc = AdamWConfig()
    with common.fake_mode():
        opt = adamw_init(params, oc)
    fn = train_step(lambda p, b: gm.loss_fn(p, b, cfg), oc)
    if mesh is not None:
        batch_specs, fn = gnn_rank_batch(batch_specs, fn, mesh, device)
    return Rank.of("gnn", n, mesh).run(fn), (params, opt, batch_specs), gnn_model_flops(cfg, n, e)


def gnn_rank_batch(batch_specs, fn, mesh, device):
    """Rank 0's own rows of every batch leaf the mesh divides (fake
    tensors: the step's arguments are what the rank holds), and ``fn``
    taking them as the flat DTensors ``launch.train.shard_graph`` makes."""
    bshard = shd.batch_shardings("gnn", batch_specs, mesh)
    rows = {k: v.shape[0] for k, v in batch_specs.items()
            if bshard[k].spec and bshard[k].spec[0]}
    local = {k: common.fake_tensor(shd.shard_shape(v.shape, bshard[k]), v.dtype, device)
             if k in rows else v for k, v in batch_specs.items()}

    def on_rows(p, o, batch):
        dm = shd.flat_mesh(mesh)
        return fn(p, o, {k: shd.from_rows(v, rows[k], dm) if k in rows else v
                         for k, v in batch.items()})

    return local, on_rows


def gnn_model_flops(cfg, n_nodes: int, n_edges: int) -> float:
    """The JAX dry-run's model flops of a GNN train step: 3 matmul passes
    (forward + 2 backward) over the layers' matmuls."""
    d, d_in = cfg.d_hidden, cfg.d_in
    per_layer = 2 * n_nodes * (d_in if cfg.n_layers == 1 else d) * d
    if cfg.variant == "graphcast":
        per_layer += 2 * n_edges * (2 * d + cfg.d_edge) * cfg.d_edge
    return 3.0 * (2 * n_nodes * d_in * d + (cfg.n_layers - 1) * per_layer)


def recsys_cell(spec, shape_id: str, shape: Dict, device="cuda", mesh=None):
    """``(fn, args, model_flops)`` of an AutoInt cell: the train step,
    ``forward`` (serve) or ``retrieval_score``; on a mesh the rank's rows
    (the tables whole: JAX's rule gives them ``P()``)."""
    cfg = spec.config
    kind = shape["kind"]
    batch = shape["batch"]
    rank = Rank.of("recsys", batch, mesh)
    if kind == "train":
        params = common.trainable(autoint.abstract_params(cfg, device))
        oc = AdamWConfig()
        with common.fake_mode():
            opt = adamw_init(params, oc)
        fn = train_step(lambda p, b: autoint.loss_fn(p, b, cfg), oc, group=rank.group)
        args = (params, opt, autoint.input_specs(cfg, "train", rank.rows, device=device))
    elif kind == "serve":
        def fn(p, b):
            return autoint.forward(p, b, cfg)

        args = (autoint.abstract_params(cfg, device),
                autoint.input_specs(cfg, "serve", rank.rows, device=device))
    else:
        def fn(p, b):
            return autoint.retrieval_score(p, b, cfg)

        args = (autoint.abstract_params(cfg, device),
                autoint.input_specs(cfg, "retrieval", rank.rows, shape["n_candidates"],
                                    device))
    return rank.run(fn), args, recsys_model_flops(cfg, shape)


def recsys_model_flops(cfg, shape: Dict) -> float:
    """The JAX dry-run's model flops of an AutoInt cell: interaction and
    MLP (embedding lookups are bytes, not flops), ×3 for a train step, plus
    the candidates' dot products of a retrieval."""
    kind, batch = shape["kind"], shape["batch"]
    f, da = cfg.n_fields, cfg.d_attn
    attn_flops = cfg.n_attn_layers * (
        2 * f * (cfg.embed_dim * da * 3) + 2 * f * f * da * 2)
    mlp_flops = 2 * sum(a * b for a, b in zip((f * da,) + cfg.mlp_dims, cfg.mlp_dims + (1,)))
    mult = 3.0 if kind == "train" else 1.0
    model_flops = mult * batch * (attn_flops + mlp_flops)
    if kind == "retrieval":
        model_flops += 2.0 * shape["n_candidates"] * da
    return model_flops


CELLS = {"lm": lm_cell, "gnn": gnn_cell, "recsys": recsys_cell}


def cell_model_flops(arch_id: str, shape_id: str) -> float:
    """The model flops of a cell at its arch's full config, as its cell
    function computes them."""
    spec = configs.get_spec(arch_id)
    shape = spec.shapes[shape_id]
    if spec.family == "lm":
        return lm_model_flops(spec.config, shape)
    if spec.family == "recsys":
        return recsys_model_flops(spec.config, shape)
    cfg = configs.resolve_gnn_config(spec.config, shape_id, shape)
    return gnn_model_flops(cfg, *gnn_graph_size(shape))


# ---------------------------------------------------------------------------
# records and the CLI


def default_hw(device) -> HW:
    """The card's :class:`HW` when tracing for a present card, else the
    datasheet's."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return HW.from_card()
    return HW()


def dryrun_cell(arch_id: str, shape_id: str, mesh_kind: str = "card", device="cuda",
                hw: Optional[HW] = None, reduced: bool = False) -> Dict[str, Any]:
    """The record of one cell on ``mesh_kind`` (:data:`MESHES`; see
    module); ``reduced`` traces the arch's reduced config at the same
    shape."""
    if mesh_kind not in MESHES:
        raise ValueError(f"unknown mesh {mesh_kind!r}: one of {sorted(MESHES)}")
    spec = configs.get_spec(arch_id)
    shape = spec.shapes[shape_id]
    mesh_shape, axes = MESHES[mesh_kind]
    n_devices = math.prod(mesh_shape)
    rec: Dict[str, Any] = {"arch": arch_id, "shape": shape_id, "mesh": mesh_kind,
                           "mesh_shape": dict(zip(axes, mesh_shape)),
                           "device": str(device), "reduced": reduced,
                           "shape_params": dict(shape)}
    skip = spec.skips.get(shape_id)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    hw = hw or default_hw(device)
    if reduced:
        spec = dataclasses.replace(spec, config=spec.reduced)
    rec["param_mode"] = PARAM_MODE.get((arch_id, shape_id), "fsdp")
    rec["microbatch"] = MICROBATCH.get((arch_id, shape_id), 1) if spec.family == "lm" else 1
    try:
        with fake_ranks(mesh_shape, axes, device) as mesh, common.fake_mode():
            if spec.family == "lm" and tm.tensor_parallel(mesh):
                cfg, m = spec.config, mesh.shape["model"]
                (q0, q1), (k0, k1) = tm.head_plan(cfg, shd.ModelAxis(None, m, 0))
                rec["tp"] = {"model": m, "query_heads_per_rank": q1 - q0,
                             "kv_heads_per_rank": k1 - k0,
                             "query_heads_whole": cfg.n_heads % m != 0,
                             "kv_heads_whole": cfg.n_kv_heads % m != 0}
            fn, args, model_flops = CELLS[spec.family](
                spec, shape_id, shape, device, mesh=None if n_devices == 1 else mesh)
            result = trace(fn, args, hw, n_devices, model_flops)
    except Exception as e:  # record failures — they are bugs to fix
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        return rec
    rec.update(status="ok", n_devices=n_devices, model_flops=model_flops, **result)
    return rec


def _palgol_step_plans(algos=("sssp", "wcc", "sv", "chain4"), costs=None) -> dict:
    """Per-step superstep plans of the representative programs under every
    schedule (JAX's ``_palgol_step_plans`` on the port's ``core``), each
    annotated with its modeled wire bytes when ``costs`` is given, plus the
    byte-aware ``auto`` pick and the fused program schedule."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import compile_program
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import SCHEDULES, program_plan_records
    from repro_torch.graph import generators as G

    small = G.erdos_renyi(64, 4.0, directed=False, weighted=True, seed=0, device="cpu")
    out = {}
    for name in algos:
        init_fields = None
        if name == "chain4":
            init_fields = {"D": torch.zeros((64,), dtype=torch.int32)}
        cp = compile_program(alg.ALL[name], small, initial_fields=init_fields)
        cell = {sched: program_plan_records(cp.step_plans(sched), costs=costs)
                for sched in SCHEDULES}
        if costs is not None:
            cell["auto_bytes"] = program_plan_records(
                dataclasses.replace(cp, byte_costs=costs).step_plans("auto"), costs=costs)
        unfused = plan_mod.lower_program(cp.prog, schedule="pull")
        fused = plan_mod.fuse(unfused)
        ub, up, _ = unfused.cost()
        fb, fp, _ = fused.cost()
        cell["fused_program"] = {
            "items": fused.describe(),
            "base": fb,
            "per_iter": {str(k): v for k, v in fp.items()},
            "unfused_base": ub,
            "unfused_per_iter": {str(k): v for k, v in up.items()},
        }
        out[name] = cell
    return out


def palgol_partition_cell(n_shards: int = 256, scale: int = 18,
                          out_dir: Path = OUT_DIR) -> dict:
    """The partitioned Palgol layout at ``n_shards`` shards, host-side and
    exact (JAX's ``palgol_partition_cell`` on the port's partitioner): an
    R-MAT of ``scale`` partitioned one shard a card, its balance, halo and
    bytes a superstep against the replicated layout, and the superstep
    plans each schedule dispatches. Writes ``palgol_partition.json`` under
    ``out_dir``."""
    from repro_torch.graph import generators as G
    from repro_torch.graph.partition import byte_cost_model, comm_bytes_report

    g = G.rmat(scale, avg_degree=16.0, directed=True, seed=0, device="cpu")
    rec = dict(comm_bytes_report(g, n_shards))
    stats = rec["partition"]
    rec["status"] = "ok"
    rec["balance"] = max(stats["pull_edges_per_shard"]) / max(1.0, stats["n_edges"] / n_shards)
    costs = byte_cost_model(g, n_shards, request_set=max(1, stats["halo_total"]),
                            combined_request_set=max(1, stats["halo_total"] // 4))
    rec["byte_cost_model"] = {
        "n_vertices": costs.n_vertices,
        "halo_bytes": costs.halo_bytes,
        "request_set": costs.request_set,
        "combined_request_set": costs.combined_request_set,
    }
    rec["step_plans"] = _palgol_step_plans(costs=costs)
    for name, cell in rec["step_plans"].items():
        for sched, steps in cell.items():
            if sched == "fused_program":
                print(f"plan {name} fused program: base={steps['base']} "
                      f"per_iter={steps['per_iter']} (unfused base={steps['unfused_base']} "
                      f"per_iter={steps['unfused_per_iter']})", flush=True)
                for line in steps["items"]:
                    print(f"  {line}", flush=True)
                continue
            for i, s in enumerate(steps):
                print(f"plan {name} step{i} [{sched}->{s['resolved']}] "
                      f"({s['supersteps']} ss, ~{s.get('bytes', 0)/1e3:.1f}KB): {s['ops']}",
                      flush=True)
    path = Path(out_dir) / "palgol_partition.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=2))
    red = rec["reduction_vs_replicated"]
    print(f"palgol-partition: shards={n_shards} n={stats['n_vertices']} "
          f"e={stats['n_edges']} balance={rec['balance']:.3f} "
          f"halo_total={stats['halo_total']} "
          f"reduction={'inf' if red is None else f'{red:.2f}'}x", flush=True)
    return rec


def summary(rec: Dict[str, Any]) -> str:
    """One line of an ``ok`` record: peak GB, fits, collective GB a rank,
    bottleneck, bound."""
    m, r = rec["memory"], rec["roofline"]
    return (f"ok: trace={rec['trace_s']:.2f}s peak/dev={m['peak_per_device_bytes'] / 1e9:.2f}GB "
            f"fits={m['fits']} coll/dev={rec['collectives']['total'] / 1e9:.3f}GB "
            f"bottleneck={r['bottleneck']} "
            f"step_lower_bound={r['step_lower_bound_s']:.4g}s "
            f"roofline_frac={r.get('roofline_fraction', 0):.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card", choices=["card", "single", "multi", "both"],
                    help="both: single and multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true", help="each arch's reduced config")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--palgol-partition", action="store_true",
                    help="host-side partition layout dry-run only")
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--graph-scale", type=int, default=18)
    args = ap.parse_args(argv)

    if args.palgol_partition:
        palgol_partition_cell(args.shards, args.graph_scale, Path(args.out))
        return 0
    archs = configs.all_arch_ids() if (args.all or not args.arch) else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out_root = Path(args.out)
    n_ok = n_fail = n_skip = 0
    for mesh_kind, arch in ((m, a) for m in meshes for a in archs):
        spec = configs.get_spec(arch)
        for shape_id in ([args.shape] if args.shape else list(spec.shapes)):
            path = out_root / mesh_kind / f"{arch}__{shape_id}.json"
            if args.skip_existing and path.exists():
                if json.loads(path.read_text()).get("status") == "ok":
                    print(f"[cached] {mesh_kind} {arch} {shape_id}")
                    n_ok += 1
                    continue
            print(f"[dryrun] {mesh_kind} {arch} {shape_id} ...", flush=True)
            rec = dryrun_cell(arch, shape_id, mesh_kind, args.device, reduced=args.reduced)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(rec, indent=2))
            st = rec["status"]
            n_ok += st == "ok"
            n_fail += st == "failed"
            n_skip += st == "skipped"
            if st == "ok":
                print("  " + summary(rec), flush=True)
                print("  launches:", rec["launches"], flush=True)
            elif st == "failed":
                print(f"  FAILED: {rec['error']}", flush=True)
            else:
                print(f"  skipped: {rec['reason']}", flush=True)
    print(f"done: ok={n_ok} failed={n_fail} skipped={n_skip}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
