"""Staged BSP executor: one eager dispatch per Pregel superstep.

The port of ``repro.pregel.runtime``. The whole Palgol program is
lowered by :func:`repro_torch.core.plan.lower_program` to a
:class:`~repro_torch.core.plan.ProgramPlan` and — by default — rewritten
by :func:`repro_torch.core.plan.fuse` (state merging + iteration fusion,
§4.3). This runtime executes **one superstep at a time**: a merged
superstep's parts run in order inside it, threading a program-level
mailbox (chain/neighborhood buffers, pending remote-write payloads) between
supersteps. Torch runs eagerly, so a superstep is a sequence of kernel
launches rather than one compiled call. ``fuse=False`` keeps the per-op
expansion — same results, more supersteps.

* ``schedule="pull"`` plans chain reads by the PullSolver gather DAG;
* ``schedule="push"`` runs the paper-faithful message schedule: each
  ``push_request`` op combines requester ids per owner (a scatter-min),
  each ``push_reply`` op ships one combined reply per distinct owner;
* ``schedule="naive"`` emulates the hand-written request/reply style: every
  chain hop costs a *request* superstep (a real scatter of requester ids)
  and a *reply* superstep (the gather);
* ``schedule="auto"`` picks the cheapest plan per step;
* fixed-point termination is checked on the host between supersteps, like
  Pregel's aggregator round-trip (one device-to-host read per iteration);
  the per-iteration frontier size is recorded in ``BSPResult.active_sets``;
* ``placement="partitioned"`` runs the same plan walk over edge-balanced
  shards, one process per shard (``repro_torch.graph.partition``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import ast
from repro_torch.core import plan as plan_mod
from repro_torch.core.codegen import HALTED, StepExecutor, _RemoteMsg, make_stop_fn
from repro_torch.core.plan import (
    ByteCostModel,
    ReadRound,
    RemoteUpdate,
    StepPlan,
    lower_step,
)
from repro_torch.graph import ops as gops
from repro_torch.graph.structure import as_field


@dataclasses.dataclass
class BSPResult:
    fields: Dict[str, torch.Tensor]
    supersteps: int
    trips: List[int]
    # per loop entry, per iteration: number of vertices whose fix fields
    # changed that iteration (the fixed-point frontier)
    active_sets: List[List[int]] = dataclasses.field(default_factory=list)


class _StagedStep:
    """One Palgol step: its :class:`StepPlan` compiled to per-op superstep
    callables ``(fields, mailbox) -> (fields, mailbox)``; ``ns`` prefixes
    this step's mailbox keys so supersteps from different steps can share
    the program-level mailbox of the fused plan.

    Like the JAX runtime, this path does not reuse
    :func:`repro_torch.core.codegen.exec_plan_part`: the staged supersteps
    also run the *wire traffic* of each round — the naive ``:req``
    requester scatters and the push combined-request buffers — which the
    whole-program path omits.
    """

    def __init__(self, plan: StepPlan, graph, ns: str = ""):
        self.step = plan.step
        self.graph = graph
        self.plan = plan
        self.info = plan.info
        self.ns = ns

    # -- mailbox keys ---------------------------------------------------------
    def _key(self, pattern) -> str:
        return self.ns + "chain:" + "/".join(pattern)

    def _pkey(self, pattern) -> str:
        return self.ns + "pushaddr:" + "/".join(pattern)

    def _nkey(self, direction, pattern) -> str:
        return f"{self.ns}nbr:{direction}:" + "/".join(pattern)

    # -- read supersteps -----------------------------------------------------
    def read_stage_fns(self):
        """List of ``(fields, mailbox) -> mailbox`` callables, one per
        ReadRound op of the plan, in order (the accounting-mirror API; the
        JAX package's are jitted, these run eagerly)."""
        return [self._stage_fn(op) for op in self.plan.ops if isinstance(op, ReadRound)]

    def _ids(self) -> torch.Tensor:
        return torch.arange(
            self.graph.n_vertices, dtype=torch.int32, device=self.graph.device
        )

    def _combine_requests(self, owner, combine: str):
        """Requester-id scatter by owner — the request-superstep wire
        traffic. ``combine="set"`` is the naive per-requester buffer
        (colliding requesters overwrite: no combining, as manual code);
        ``combine="min"`` is Pregel message combining (one deterministic
        slot per distinct owner). ``n_vertices`` is the empty sentinel."""
        ids = self._ids()
        reqbuf = torch.full_like(ids, self.graph.n_vertices)
        if combine == "set":
            return gops.scatter_set(reqbuf, owner, ids)
        return gops.scatter_combine(reqbuf, owner, ids, "min")

    def _stage_fn(self, op: ReadRound):
        if op.kind == "request":

            def request(fields, mailbox, _op=op):
                # requester u pushes its id to the owner vertex (real
                # scatter: the message traffic manual Pregel code pays)
                out = dict(mailbox)
                for ce in _op.chains:
                    owner = self._lookup(fields, out, ce.prefix)
                    out[self._key(ce.pattern) + ":req"] = (
                        self._combine_requests(owner, "set")
                    )
                return out

            return request

        if op.kind == "push_request":

            def push_request(fields, mailbox, _op=op):
                # address-propagation round: requester ids move one hop
                # along the chain, message-combined per owner
                out = dict(mailbox)
                for send in _op.sends:
                    owner = self._resolve(fields, out, send.target)
                    if owner is None:
                        continue
                    out[self._pkey(send.target) + ":req"] = (
                        self._combine_requests(owner, _op.combiner or "min")
                    )
                return out

            return push_request

        def stage(fields, mailbox, _op=op):
            # "pull": one gather-DAG round; "reply": the owner returns its
            # value to the requester; "push_reply": one combined reply per
            # distinct owner, fanned out to its requesters (the gather),
            # with the request set segment-combined per owner;
            # "nbr_send": per-edge buffers
            out = dict(mailbox)
            for ce in _op.chains:
                pre = self._lookup(fields, out, ce.prefix)
                suf = self._lookup(fields, out, ce.suffix)
                val = gops.gather(suf, pre)
                if _op.kind == "push_reply":
                    # fold the combined request buffer into the reply: the
                    # term is exactly zero (reqbuf < n + 2), the combining
                    # scatter is the round's wire traffic
                    reqbuf = self._combine_requests(pre, _op.combiner or "min")
                    zero = torch.floor_divide(
                        gops.gather(reqbuf, pre), self.graph.n_vertices + 2
                    )
                    val = val + zero.to(val.dtype)
                out[self._key(ce.pattern)] = val
                out.pop(self._key(ce.pattern) + ":req", None)
            if _op.kind == "push_reply":
                # the paired push_request's address buffers were the wire
                # accounting of *their* superstep; drop them
                prefix = self.ns + "pushaddr:"
                for k in [k for k in out if k.startswith(prefix)]:
                    out.pop(k)
            for direction, npat in _op.nbr_sends:
                nbr, _, _, _ = self.graph.edges(direction)
                val = self._lookup(fields, out, npat)
                out[self._nkey(direction, npat)] = gops.gather(val, nbr)
            return out

        return stage

    def _resolve(self, fields, mailbox, pattern):
        """Pattern value if materialized/axiomatic, else None (push address
        flows may target chains materialized later the same round)."""
        if len(pattern) <= 1 or self._key(pattern) in mailbox:
            return self._lookup(fields, mailbox, pattern)
        return None

    def _lookup(self, fields, mailbox, pattern):
        if len(pattern) == 0:
            return self._ids()
        if len(pattern) == 1:
            if pattern[0] == "Id":
                return self._ids()
            return fields[pattern[0]]
        return mailbox[self._key(pattern)]

    # -- per-op superstep callables -------------------------------------------
    def op_fn(self, op):
        """``(fields, mailbox) -> (fields, mailbox)`` for one plan op — the
        building block the per-superstep dispatcher composes."""
        if isinstance(op, ReadRound):
            stage = self._stage_fn(op)

            def read(fields, mailbox):
                return fields, stage(fields, mailbox)

            return read
        if isinstance(op, RemoteUpdate):
            return self._update_fn(op)
        return self._main_fn()

    def _main_fn(self):
        has_ru = self.plan.has_remote_update
        materialized = self.plan.materialized
        pending_key = self.ns + "pending"

        def main(fields, mailbox):
            chain_values = {
                p: mailbox[self._key(p)]
                for p in materialized
                if self._key(p) in mailbox
            }
            nbr_values = {
                (d, p): mailbox[self._nkey(d, p)]
                for d, p in self.info.nbr_comms
                if self._nkey(d, p) in mailbox
            }
            # the step's read buffers are consumed here
            out = {
                k: v for k, v in mailbox.items()
                if not k.startswith(self.ns)
            }
            ex = StepExecutor(self.step, self.graph, plan=self.plan)
            if has_ru:
                new, pending = ex(
                    fields, chain_values, split_remote=True,
                    nbr_values=nbr_values,
                )
                out[pending_key] = tuple(
                    (m.idx, m.values, m.mask) for m in pending
                )
                return new, out
            return ex(fields, chain_values, nbr_values=nbr_values), out

        return main

    def _update_fn(self, ru: RemoteUpdate):
        pending_key = self.ns + "pending"

        def update(fields, mailbox):
            out = dict(mailbox)
            payload = out.pop(pending_key)
            ex = StepExecutor(self.step, self.graph, plan=self.plan)
            msgs = [
                _RemoteMsg(f, op, idx, val, mask)
                for (f, op), (idx, val, mask) in zip(ru.writes, payload)
            ]
            return ex.apply_remote(fields, msgs), out

        return update


def read_superstep_count(step: ast.Step, schedule: str) -> int:
    """Number of remote-reading supersteps a step costs under ``schedule``
    — ``lower_step(step).read_rounds``, the same plan every executor
    dispatches."""
    return lower_step(step, schedule=schedule).read_rounds


def _frontier_size(before, after, fix_fields, group=None) -> int:
    """Vertices whose fix fields changed this iteration (the fixed-point
    frontier) — one device-to-host read. Under a partitioned placement the
    fields are this shard's rows and the count is all-reduced over
    ``group``, so every rank sees the global frontier and takes the same
    branch."""
    changed = None
    for f in fix_fields:
        d = after[f] != before[f]
        if d.ndim > 1:
            d = d.reshape(d.shape[0], -1).any(dim=-1)
        changed = d if changed is None else torch.logical_or(changed, d)
    count = changed.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    return int(count)


def walk_plan(
    pp: plan_mod.ProgramPlan,
    fields,
    exec_superstep,
    counter: List[int],
    trips: List[int],
    max_iters: int,
    active_sets: Optional[List[List[int]]] = None,
    group=None,
):
    """Host-side walk of a (fused) program plan, shared by both placements.

    ``exec_superstep(superstep, fields)`` executes ONE plan superstep
    (fused parts included) and returns the new fields; this walker owns
    sequencing, trip counting, the host-side OR-aggregator fixed-point
    check, the superstep counter (one per dispatched superstep — the fused
    accounting), and the per-iteration frontier instrumentation. ``group``
    is the process group of a partitioned run (see :func:`_frontier_size`).
    """

    def run(items, flds):
        for it in items:
            if isinstance(it, plan_mod.Superstep):
                flds = exec_superstep(it, flds)
                counter[0] += 1
                continue
            # PlanLoop
            trips.append(0)
            slot = len(trips) - 1
            if active_sets is not None:
                active_sets.append([])
            node = it.node
            limit = (
                node.fixed_trips
                if node.fixed_trips is not None
                else max_iters
            )
            for _ in range(limit):
                before = {f: flds[f] for f in node.fix_fields}
                flds = run(it.body, flds)
                trips[slot] += 1
                if node.fix_fields:
                    # host-side aggregator round-trip (Pregel OR-aggregator)
                    frontier = _frontier_size(
                        before, flds, node.fix_fields, group
                    )
                    if active_sets is not None:
                        active_sets[slot].append(frontier)
                    if frontier == 0:
                        break
        return flds

    out = run(pp.items, fields)
    del run  # ``run`` calls itself through its closure: free that cycle now
    return out


def run_bsp(
    prog: ast.Prog,
    graph,
    fields: Dict[str, torch.Tensor],
    schedule: str = "pull",
    max_iters: int = 100_000,
    placement: str = "replicated",
    mesh=None,
    n_shards: Optional[int] = None,
    group=None,
    byte_costs: Optional[ByteCostModel] = None,
    fuse: bool = True,
) -> BSPResult:
    """Execute a Palgol program superstep-by-superstep on the graph's device.

    ``fields`` must be the full canonical field dict (use
    ``CompiledProgram.init_fields``); values may be tensors or numpy arrays
    and are moved to the graph's device. Returns final fields, the number
    of executed supersteps, per-iteration trip counts, and the
    per-iteration fixed-point frontier sizes.

    ``schedule`` ∈ {"pull", "push", "naive", "auto"} selects the
    chain-access lowering; ``byte_costs`` makes ``"auto"`` select on the
    byte model. ``fuse`` (default True) executes the §4.3-fused program
    plan; ``fuse=False`` the unfused per-op expansion (identical results,
    the historical superstep counts).

    ``placement`` selects the vertex-state layout:

    * ``"replicated"`` (default) — dense ``[N]`` tensors on the graph's
      device;
    * ``"partitioned"`` — edge-balanced contiguous-range shards with halo
      exchange (``repro_torch.graph.partition``), one process per shard:
      every rank of the process group calls ``run_bsp``. ``mesh`` (a
      :func:`repro_torch.dist.shard_mesh`), or ``n_shards`` and ``group``,
      select the layout; without a process group there is one shard, run
      in the calling process. ``graph`` may be a dense graph or a
      ``PartitionedGraph`` built once. Fields are partitioned on entry and
      returned dense on every rank, so callers are placement-agnostic.
    """
    if placement == "partitioned":
        from repro_torch.graph.partition import run_bsp_partitioned

        return run_bsp_partitioned(
            prog, graph, fields, schedule=schedule, max_iters=max_iters,
            mesh=mesh, n_shards=n_shards, group=group, byte_costs=byte_costs,
            fuse=fuse,
        )
    if placement != "replicated":
        raise ValueError(f"unknown placement {placement!r}")
    pp = plan_mod.lower_program(prog, schedule=schedule, byte_costs=byte_costs)
    if fuse:
        pp = plan_mod.fuse(pp)

    counter = [0]
    trips: List[int] = []
    active_sets: List[List[int]] = []
    # one _StagedStep per step, one composed callable per Superstep —
    # supersteps re-execute across iterations without re-planning
    staged: Dict[int, _StagedStep] = {}
    ss_fns: Dict[int, object] = {}
    mailbox_box = [{}]

    def staged_for(ref: plan_mod.OpRef) -> _StagedStep:
        if ref.sidx not in staged:
            staged[ref.sidx] = _StagedStep(ref.plan, graph, ns=f"s{ref.sidx}:")
        return staged[ref.sidx]

    def build_ss_fn(ss: plan_mod.Superstep):
        part_fns = []
        for ref in ss.parts:
            op = ref.op
            if isinstance(op, plan_mod.IterInit):
                continue
            if isinstance(op, plan_mod.StopOp):
                stop = make_stop_fn(op.stop, graph)
                part_fns.append(lambda f, m, _s=stop: (_s(f), m))
            else:
                part_fns.append(staged_for(ref).op_fn(op))

        def ss_fn(flds, mailbox):
            for fn in part_fns:
                flds, mailbox = fn(flds, mailbox)
            return flds, mailbox

        return ss_fn

    def exec_superstep(ss: plan_mod.Superstep, flds):
        if id(ss) not in ss_fns:
            ss_fns[id(ss)] = build_ss_fn(ss)
        flds, mailbox_box[0] = ss_fns[id(ss)](flds, mailbox_box[0])
        return flds

    fields = {k: as_field(v, graph.device) for k, v in fields.items()}
    if HALTED not in fields:
        fields[HALTED] = torch.zeros(
            (graph.n_vertices,), dtype=torch.bool, device=graph.device
        )
    out = walk_plan(
        pp, fields, exec_superstep, counter, trips, max_iters,
        active_sets=active_sets,
    )
    return BSPResult(
        fields=out, supersteps=counter[0], trips=trips,
        active_sets=active_sets,
    )
