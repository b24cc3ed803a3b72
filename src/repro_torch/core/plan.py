"""The superstep-plan IR: one canonical lowering of Palgol steps.

The paper's compilation story (§5) is a single expansion of each Palgol
step into Pregel supersteps: remote-reading supersteps that materialize the
chain-access buffers, one main (local-computation) superstep, and one
remote-updating superstep when the step has remote writes. This module is
the *only* place that expansion lives: :func:`lower_step` lowers a step to
a :class:`StepPlan` — a typed list of superstep ops — and every executor
consumes the plan instead of re-deriving it:

* the fused dense compiler (``repro.core.codegen.StepExecutor``) folds the
  op list into its single traced computation;
* the staged BSP executor (``repro.pregel.runtime``) dispatches one device
  call per op;
* the partitioned executor (``repro.graph.partition.executor``) maps each
  op onto its halo collective (``ReadRound`` → ``gather_global`` /
  ``halo_exchange``, ``RemoteUpdate`` → ``scatter_reduce``).

One op is one Pregel superstep, so ``len(plan.ops)`` *is* the step's
superstep cost — the STM cost models (``repro.core.stm``) count plan ops
directly, and accounting can never diverge from execution by construction.

Schedules
---------
``"pull"``
    The logic-system-derived one-sided schedule: chain patterns evaluate
    through the :class:`~repro.core.logic.PullSolver` gather DAG, one
    ``ReadRound`` per DAG depth (pointer doubling — ``D⁴`` in 2 rounds);
    neighborhood sends piggyback on the round after their chain is ready.
``"push"``
    The paper-faithful message-passing schedule (§4): chain patterns
    evaluate through the :class:`~repro.core.logic.PushSolver` derivation
    — requester addresses are forwarded along the chain while values
    double back, so ``D⁴`` costs 3 rounds instead of naive's 6. Rounds
    come in two kinds: ``push_request`` (address propagation only) and
    ``push_reply`` (a combined-reply round: the owner's value is sent
    once per combined request — Pregel message combining, the
    ``combiner`` op on the round — and materializes chain buffers).
    Neighborhood sends are the classic combined push along edges.
``"naive"``
    Hand-written-Pregel request/reply: every chain hop costs a *request*
    round (push requester ids to the owner — a real scatter) and a *reply*
    round (the owner returns the value), sequentially per pattern, plus one
    neighborhood-send round. The wire traffic manual code pays, with no
    message combining.
``"auto"``
    Per-step selection among the three: lower under every schedule and
    keep the cheapest plan. Without a :class:`ByteCostModel` the metric is
    the plan's own op count (the superstep cost model; ties go
    ``pull`` → ``push`` → ``naive``). With one, the metric is
    ``supersteps · superstep_overhead_bytes + plan_bytes(plan)`` — the
    byte-aware selection that lets naive/push win on tiny request sets at
    deep chains, following the channel-composition line of Zhang & Hu
    (1811.01669) and the combiner-driven push/pull knob of iPregel
    (2010.08781).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import ast
from repro_torch.core.analysis import StepInfo, analyze_step
from repro_torch.core.logic import Pattern, PullSolver, PushPlan, PushSolver

#: the halted-mask pseudo-field (paper §3.4); lives here so the plan IR's
#: read/write-set analysis and the executors share one spelling
HALTED = "_halted"

#: the schedules lower_step accepts
SCHEDULES = ("pull", "push", "naive", "auto")

#: schedules auto chooses among, in tie-break preference order
_AUTO_ORDER = ("pull", "push", "naive")


@dataclasses.dataclass(frozen=True)
class ChainEval:
    """One gather: materialize ``pattern`` as ``eval(suffix)[eval(prefix)]``.

    Both operands are already-materialized patterns (or axioms: ``()`` is
    the vertex id, a single field is a local array read). Pull rounds use
    the PullSolver's balanced split; naive hops always split off the last
    field (``prefix = pattern[:-1]``, ``suffix = (pattern[-1],)``); push
    rounds split at the derivation's chosen intermediate (``prefix = via``,
    ``suffix = pattern/via`` — the value the via-vertex ships back).
    """

    pattern: Pattern
    prefix: Pattern
    suffix: Pattern


@dataclasses.dataclass(frozen=True)
class PushSend:
    """One message flow of the push derivation completing this round:
    vertex ``via(u)`` sends ``expr(u)`` to vertex ``target(u)``
    (``expr = ()`` is the requester id — address propagation;
    ``target = ()`` is the requester itself — a value delivery).
    Recorded for wire accounting (:func:`plan_bytes`) and ``describe``;
    value deliveries also appear as the round's executable ``chains``.
    """

    target: Pattern
    expr: Pattern
    via: Pattern


@dataclasses.dataclass(frozen=True)
class ReadRound:
    """One remote-reading superstep.

    ``kind``:

    * ``"pull"`` — one pull-solver gather round (``chains`` are the DAG
      nodes at this depth; ``nbr_sends`` piggyback once their chain is
      ready);
    * ``"request"`` — naive hop, requester→owner address scatter for the
      single entry in ``chains`` (no value materialized);
    * ``"reply"`` — naive hop, owner→requester value gather (materializes
      ``chains[0].pattern``);
    * ``"nbr_send"`` — the naive schedule's neighborhood-send superstep
      (``nbr_sends`` only);
    * ``"push_request"`` — push round carrying only address propagation
      (``sends``; requester ids forwarded along the chain, combined per
      owner with ``combiner``);
    * ``"push_reply"`` — push round delivering values: ``chains`` are the
      buffers it materializes (one combined reply per distinct owner —
      message combining with ``combiner``), ``sends`` any piggybacked
      address flows, ``nbr_sends`` the combined neighborhood pushes.
    """

    kind: str
    chains: Tuple[ChainEval, ...] = ()
    nbr_sends: Tuple[Tuple[str, Pattern], ...] = ()  # (direction, pattern)
    sends: Tuple[PushSend, ...] = ()  # push message flows (accounting)
    combiner: Optional[str] = None  # message-combining op on push rounds
    general: int = 0  # general-read conversation legs riding this round


@dataclasses.dataclass(frozen=True)
class MainCompute:
    """The main superstep: local computation + emitting remote writes."""

    emits_remote: bool = False


@dataclasses.dataclass(frozen=True)
class RemoteUpdate:
    """The remote-updating superstep: apply combined messages at owners."""

    writes: Tuple[Tuple[str, str], ...]  # (field, op) in program order


PlanOp = object  # ReadRound | MainCompute | RemoteUpdate

#: ReadRound kinds that materialize their ``chains`` as value buffers
VALUE_KINDS = ("pull", "reply", "push_reply")

#: ReadRound kinds that carry addresses only (no buffer materialized)
REQUEST_KINDS = ("request", "push_request")


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """A Palgol step lowered to its superstep op list.

    ``schedule`` is the *resolved* schedule (``pull``/``push``/``naive``);
    ``requested`` records what the caller asked for (may be ``auto``).
    """

    step: ast.Step
    info: StepInfo
    schedule: str
    requested: str
    ops: Tuple[PlanOp, ...]

    @property
    def n_supersteps(self) -> int:
        """Superstep cost of one execution of this step — the accounting
        contract: one op is one superstep."""
        return len(self.ops)

    @property
    def read_rounds(self) -> int:
        return sum(1 for op in self.ops if isinstance(op, ReadRound))

    @property
    def has_remote_update(self) -> bool:
        return any(isinstance(op, RemoteUpdate) for op in self.ops)

    @property
    def materialized(self) -> Tuple[Pattern, ...]:
        """Every chain pattern some ReadRound materializes (mailbox keys of
        the staged executor), in materialization order."""
        out: List[Pattern] = []
        for op in self.ops:
            if isinstance(op, ReadRound) and op.kind in VALUE_KINDS:
                out.extend(ce.pattern for ce in op.chains)
        return tuple(dict.fromkeys(out))

    def describe(self) -> str:
        """Compact one-line rendering for dry-runs and logs."""
        parts = []
        for op in self.ops:
            if isinstance(op, ReadRound):
                items = [".".join(ce.pattern) for ce in op.chains]
                items += [
                    f"@{'.'.join(s.target) or 'u'}<-{'.'.join(s.expr) or 'Id'}"
                    for s in op.sends
                ]
                items += [f"{d}:{'.'.join(p) or 'Id'}" for d, p in op.nbr_sends]
                parts.append(f"RR[{op.kind}{' ' if items else ''}{' '.join(items)}]")
            elif isinstance(op, MainCompute):
                parts.append("Main")
            else:
                parts.append(
                    "RU[" + " ".join(f"{f}{o}" for f, o in op.writes) + "]"
                )
        return " -> ".join(parts)


def remote_write_descs(step: ast.Step) -> Tuple[Tuple[str, str], ...]:
    """(field, op) of every remote write, in static program order — the
    message-descriptor contract between MainCompute and RemoteUpdate."""
    return tuple(
        (s.field, s.op)
        for s in ast.walk_stmts(step.body)
        if isinstance(s, ast.RemoteWrite)
    )


def _tail(ops: List[PlanOp], step: ast.Step, info: StepInfo) -> List[PlanOp]:
    ops.append(MainCompute(emits_remote=info.has_remote_writes()))
    if info.has_remote_writes():
        ops.append(RemoteUpdate(writes=remote_write_descs(step)))
    return ops


def _lower_pull(step: ast.Step, info: StepInfo) -> List[PlanOp]:
    ops: List[PlanOp] = []
    pats = info.read_patterns()
    # general (computed-index) reads inline their gather into an existing
    # round's dispatch, but still cost at least one remote-reading
    # superstep (pull_read_rounds' floor) — a step with only general reads
    # gets one chain-less round
    if pats or info.nbr_comms or info.general_reads:
        solver = PullSolver()
        order = solver.schedule(pats)
        depth = {p: solver.solve(p).rounds for p in order}
        total_rounds = info.pull_read_rounds()
        # neighborhood sends fire at round rounds(pattern)+1
        nbr_round = {
            (d, p): solver.rounds(p) + 1 for d, p in info.nbr_comms
        }
        for r in range(1, total_rounds + 1):
            chains = tuple(
                ChainEval(
                    p,
                    solver.solve(p).prefix.pattern,
                    solver.solve(p).suffix.pattern,
                )
                for p in order
                if depth.get(p) == r and len(p) > 1
            )
            sends = tuple(sorted(k for k, rr in nbr_round.items() if rr == r))
            ops.append(ReadRound("pull", chains, sends))
    return _tail(ops, step, info)


def _lower_naive(step: ast.Step, info: StepInfo) -> List[PlanOp]:
    ops: List[PlanOp] = []
    for p in info.read_patterns():
        for k in range(2, len(p) + 1):
            prefix = p[:k]
            hop = ChainEval(prefix, prefix[:-1], (prefix[-1],))
            ops.append(ReadRound("request", (hop,)))
            ops.append(ReadRound("reply", (hop,)))
    # each general (computed-index) read is one request/reply conversation
    # in manual code; the value itself is consumed inline in the main
    # superstep, so the rounds carry no chains — they cost supersteps only
    for _ in range(info.general_reads):
        ops.append(ReadRound("request"))
        ops.append(ReadRound("reply"))
    if info.nbr_comms:
        ops.append(ReadRound("nbr_send", (), tuple(sorted(info.nbr_comms))))
    return _tail(ops, step, info)


def _collect_push_sends(
    plan: PushPlan, out: Dict[Tuple[Pattern, Pattern], Tuple[int, Pattern]]
):
    """Walk a chosen PushPlan derivation, recording every non-axiom send as
    (target, expr) → (completion round, via). Shared sub-derivations dedup
    (the solver memo already shares them across patterns)."""
    if plan.rounds <= 0 or plan.via is None:
        return
    key = (plan.target, plan.expr)
    if key not in out or out[key][0] > plan.rounds:
        out[key] = (plan.rounds, plan.via)
    _collect_push_sends(plan.value_plan, out)
    _collect_push_sends(plan.addr_plan, out)


def _lower_push(step: ast.Step, info: StepInfo) -> List[PlanOp]:
    """The paper-faithful push expansion (§4.1.1 message passing).

    Chain materializations follow the PushSolver derivation: the value
    ``K_u p`` completes at round ``rounds(p)`` via intermediate ``w``, and
    the executable realization is the gather ``eval(p/w)[eval(w)]`` — so
    the via-prefix ``w`` is (recursively) scheduled for materialization
    too. For every chain pattern up to depth 8 this reproduces the
    solver's minimal round count exactly (property-tested); the defensive
    ``max`` below only extends the plan if a prefix materialization ever
    lagged its consumer, keeping the lowering correct even then.
    """
    solver = PushSolver()
    mat_round: Dict[Pattern, int] = {}
    via_of: Dict[Pattern, Pattern] = {}

    def want(p: Pattern) -> int:
        if len(p) <= 1:
            return 0
        if p in mat_round:
            return mat_round[p]
        plan = solver.solve((), p)
        via = plan.via
        r = plan.rounds
        for dep in (via, p[len(via):]):
            r = max(r, want(dep) + 1)
        mat_round[p] = r
        via_of[p] = via
        return r

    for p in info.read_patterns():
        want(p)

    # message flows of the chosen derivations, for wire accounting
    send_round: Dict[Tuple[Pattern, Pattern], Tuple[int, Pattern]] = {}
    for p in info.read_patterns():
        _collect_push_sends(solver.solve((), p), send_round)

    total = max([0] + list(mat_round.values()))
    # the neighborhood send is the classic combined Pregel push along
    # edges: it fires once the sender's chain value is materialized
    nbr_round = {
        (d, p): mat_round.get(p, 0) + 1 for d, p in info.nbr_comms
    }
    if nbr_round:
        total = max(total, max(nbr_round.values()))
    if info.general_reads:
        # one combined request/reply conversation; independent flows share
        # supersteps, so it contributes rounds 1–2 (paper's parallel flows)
        total = max(total, 2)

    ops: List[PlanOp] = []
    for r in range(1, total + 1):
        chains = tuple(
            ChainEval(p, via_of[p], p[len(via_of[p]):])
            for p in sorted(mat_round)
            if mat_round[p] == r
        )
        sends = tuple(
            PushSend(t, e, via)
            for (t, e), (rr, via) in sorted(send_round.items())
            if rr == r and t != ()  # value deliveries are the chains above
        )
        nbrs = tuple(sorted(k for k, rr in nbr_round.items() if rr == r))
        # general-read conversations ride rounds 1 (request) and 2 (reply)
        general = info.general_reads if r <= 2 else 0
        carries_values = bool(chains or nbrs or (r == 2 and general))
        kind = "push_reply" if carries_values else "push_request"
        ops.append(
            ReadRound(kind, chains, nbrs, sends, combiner="min",
                      general=general)
        )
    return _tail(ops, step, info)


_LOWERERS = {
    "pull": _lower_pull,
    "push": _lower_push,
    "naive": _lower_naive,
}


# ---------------------------------------------------------------------------
# per-op byte estimates + the byte-aware auto selector


@dataclasses.dataclass(frozen=True)
class ByteCostModel:
    """Per-round byte estimates for plan selection and reporting.

    All figures are aggregate across devices, for one value-width field.

    * ``n_vertices`` — full array width: what a pull round's one-sided
      gather ships (pointer doubling materializes intermediates at *every*
      vertex, so its request set cannot shrink);
    * ``request_set`` — live requesters per naive hop (≤ N; measured from
      the active set / halted mask, or the partition halo as a boundary
      proxy). Naive pays one request + one reply message per requester;
    * ``combined_request_set`` — requesters after message combining (push:
      one slot per distinct owner). Defaults to ``request_set`` (no
      combining advantage assumed until measured);
    * ``halo_bytes`` — one static neighborhood exchange
      (:func:`repro.graph.partition.stats.partition_stats` halo payload);
    * ``update_bytes`` — one RemoteUpdate reduce-scatter;
    * ``reply_width`` — values per reply payload (multi-field chains);
    * ``superstep_overhead_bytes`` — byte-equivalent of one superstep's
      fixed latency (barrier + dispatch); what ``auto`` charges per op on
      top of the wire bytes.
    """

    n_vertices: int
    value_bytes: int = 4
    request_set: Optional[int] = None
    combined_request_set: Optional[int] = None
    halo_bytes: Optional[int] = None
    update_bytes: Optional[int] = None
    reply_width: int = 1
    superstep_overhead_bytes: int = 0

    def resolved(self) -> "ByteCostModel":
        """Fill defaults: request_set→N, combined→request_set,
        halo/update→N values (replicated-dense worst case). Request sets
        clamp to N — each vertex issues at most one chain request per hop,
        so a measured proxy larger than N (e.g. a power-law halo) caps."""
        n = self.n_vertices
        b = self.value_bytes
        req = self.request_set if self.request_set is not None else n
        req = min(req, n)
        comb = (
            self.combined_request_set
            if self.combined_request_set is not None
            else req
        )
        comb = min(comb, req)
        halo = self.halo_bytes if self.halo_bytes is not None else n * b
        upd = self.update_bytes if self.update_bytes is not None else n * b
        return dataclasses.replace(
            self,
            request_set=req,
            combined_request_set=comb,
            halo_bytes=halo,
            update_bytes=upd,
        )


def op_bytes(op: PlanOp, costs: ByteCostModel) -> int:
    """Estimated wire bytes of one plan op under ``costs`` (resolved).

    * pull round: each chain is an array-wide one-sided gather — N ids out,
      N·reply_width values back; neighborhood sends ride the static halo;
    * naive request/reply: one message per live requester, uncombined;
    * push request/reply: one message per *combined* request slot
      (message combining), address flows (``sends``) ship combined ids;
    * MainCompute is wire-free; RemoteUpdate is one combined scatter.
    """
    b = costs.value_bytes
    if isinstance(op, MainCompute):
        return 0
    if isinstance(op, RemoteUpdate):
        return costs.update_bytes
    total = 0
    if op.kind == "pull":
        for _ in op.chains:
            total += costs.n_vertices * b * (1 + costs.reply_width)
    elif op.kind == "request":
        total += max(1, len(op.chains)) * costs.request_set * b
    elif op.kind == "reply":
        total += (
            max(1, len(op.chains))
            * costs.request_set
            * costs.reply_width
            * b
        )
    elif op.kind == "push_request":
        total += (
            max(1, len(op.sends) + op.general)
            * costs.combined_request_set
            * b
        )
    elif op.kind == "push_reply":
        total += (
            len(op.chains) * costs.combined_request_set * costs.reply_width * b
        )
        total += len(op.sends) * costs.combined_request_set * b
        # general-read conversation legs riding this round (combined)
        total += op.general * costs.combined_request_set * costs.reply_width * b
    for _ in op.nbr_sends:
        total += costs.halo_bytes
    return total


def plan_bytes(plan: StepPlan, costs: ByteCostModel) -> int:
    """Total estimated wire bytes of one execution of ``plan``."""
    costs = costs.resolved()
    return sum(op_bytes(op, costs) for op in plan.ops)


def plan_score(plan: StepPlan, costs: Optional[ByteCostModel]) -> Tuple:
    """The auto-selection metric. Without costs: op count (the plan's own
    superstep cost model). With costs: supersteps charged at the fixed
    per-superstep overhead plus the modeled wire bytes."""
    if costs is None:
        return (plan.n_supersteps,)
    costs = costs.resolved()
    return (
        plan.n_supersteps * costs.superstep_overhead_bytes
        + plan_bytes(plan, costs),
        plan.n_supersteps,
    )


def program_plan_records(step_plans, costs: Optional[ByteCostModel] = None):
    """JSON-ready records for ``CompiledProgram.step_plans()`` output — the
    one rendering the benchmark report and the partition dry-run share.
    With a :class:`ByteCostModel`, each record also carries the modeled
    per-execution wire bytes."""
    out = []
    for _, plan in step_plans:
        rec = {
            "resolved": plan.schedule,
            "read_rounds": plan.read_rounds,
            "supersteps": plan.n_supersteps,
            "ops": plan.describe(),
        }
        if costs is not None:
            rec["bytes"] = plan_bytes(plan, costs)
        out.append(rec)
    return out


def lower_step(
    step: ast.Step,
    info: Optional[StepInfo] = None,
    schedule: str = "pull",
    byte_costs: Optional[ByteCostModel] = None,
) -> StepPlan:
    """Lower a Palgol step to its :class:`StepPlan` under ``schedule``.

    The one canonical superstep expansion — every executor and the STM
    cost models consume this. ``byte_costs`` only affects ``"auto"``:
    the selector then ranks candidate plans by
    :func:`plan_score` (supersteps·overhead + modeled bytes) instead of
    bare op count.
    """
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; expected one of {SCHEDULES}"
        )
    info = info if info is not None else analyze_step(step)
    if schedule == "auto":
        candidates = [
            StepPlan(step, info, s, "auto", tuple(_LOWERERS[s](step, info)))
            for s in _AUTO_ORDER
        ]
        # stable min: ties keep the earlier (pull-first) candidate
        return min(candidates, key=lambda p: plan_score(p, byte_costs))
    ops = _LOWERERS[schedule](step, info)
    return StepPlan(step, info, schedule, schedule, tuple(ops))


# ---------------------------------------------------------------------------
# the whole-program plan: lower_program + the §4.3 fuse pass
#
# ``lower_step`` expands ONE step; a Palgol program is a Seq/Iter tree of
# steps, and the paper's headline optimizations (§4.3 state merging and
# iteration fusion) only exist at that program level. ``lower_program``
# lowers every step and linearizes the tree into a :class:`ProgramPlan` —
# ``Superstep`` items (one device dispatch each) and ``PlanLoop`` items
# (host-checked fixed points) — and :func:`fuse` rewrites it so the
# optimized schedule is what the executors actually dispatch. The STM cost
# models (``repro.core.stm``) count the same fused items, so optimized
# accounting equals optimized execution by construction — the program-level
# twin of the per-step invariant ``len(plan.ops) == supersteps``.


@dataclasses.dataclass(frozen=True)
class IterInit:
    """The iteration Init superstep (paper Fig. 11): sets up the
    OR-aggregator for the first termination check. No field reads/writes,
    so it merges freely and is the landing pad for the fused loop's
    prefetched first ReadRound."""


@dataclasses.dataclass(frozen=True)
class StopOp:
    """One StopStep superstep: evaluate the condition, flip the halted
    mask (writes :data:`HALTED` only)."""

    stop: ast.StopStep


@dataclasses.dataclass(frozen=True)
class OpRef:
    """One primitive plan op with its owning step context.

    ``plan`` is the owning :class:`StepPlan` (None for IterInit/StopOp);
    ``sidx`` is the step ordinal in program order — the executors' mailbox
    namespace, so two steps materializing the same chain pattern cannot
    collide once supersteps from different steps share a program-level
    mailbox.
    """

    op: object  # ReadRound | MainCompute | RemoteUpdate | IterInit | StopOp
    plan: Optional[StepPlan] = None
    sidx: int = -1


@dataclasses.dataclass(frozen=True)
class Superstep:
    """One fused Pregel superstep: its parts execute *in order* inside one
    dispatch. Sequencing is the fusion-correctness argument: a merged
    superstep runs exactly the primitive op sequence the unfused plan runs,
    only the dispatch boundaries move — so fused execution bit-matches
    unfused by construction. ``head`` marks the first superstep of its
    program node (the only legal merge target, as in §4.3.1)."""

    parts: Tuple[OpRef, ...]
    head: bool = False

    def describe(self) -> str:
        names = []
        for ref in self.parts:
            op = ref.op
            if isinstance(op, ReadRound):
                names.append(f"RR[{op.kind}]")
            elif isinstance(op, MainCompute):
                names.append("Main")
            elif isinstance(op, RemoteUpdate):
                names.append("RU")
            elif isinstance(op, IterInit):
                names.append("Init")
            else:
                names.append("Stop")
        return "+".join(names)


@dataclasses.dataclass(frozen=True)
class PlanLoop:
    """A fixed-point / fixed-trip iteration: ``body`` items execute per
    trip; ``fused`` records whether the §4.3.2 loop-back fusion fired (the
    body's first ReadRound was duplicated into the preceding superstep and
    merged into the body's last superstep)."""

    body: Tuple[object, ...]  # Superstep | PlanLoop
    node: ast.Iter
    iter_index: int
    fused: bool = False


@dataclasses.dataclass(frozen=True)
class ProgramPlan:
    """The whole Palgol program as an executable superstep schedule."""

    prog: ast.Prog
    schedule: str
    items: Tuple[object, ...]  # Superstep | PlanLoop
    fused: bool
    step_plans: Tuple[Tuple[ast.Step, StepPlan], ...]

    def cost(self) -> Tuple[int, Dict[int, int], List[str]]:
        """``(base, per_iter, detail)`` — supersteps as a linear functional
        of the trip counts, counted off the very items the executors walk
        (the STM :class:`~repro.core.stm.CostModel` wraps this)."""
        base = [0]
        per_iter: Dict[int, int] = {}
        detail: List[str] = []

        def count(items, key):
            for it in items:
                if isinstance(it, Superstep):
                    if key is None:
                        base[0] += 1
                    else:
                        per_iter[key] = per_iter.get(key, 0) + 1
                else:
                    count(it.body, it.iter_index)

        count(self.items, None)
        for it in self.items:
            detail.extend(_loop_details(it))
        return base[0], per_iter, detail

    def describe(self) -> List[str]:
        """One line per item, loops indented — the dry-run rendering."""
        out: List[str] = []

        def go(items, depth):
            pad = "  " * depth
            for it in items:
                if isinstance(it, Superstep):
                    out.append(pad + it.describe())
                else:
                    out.append(
                        pad + f"loop#{it.iter_index} (fused={it.fused}):"
                    )
                    go(it.body, depth + 1)

        go(self.items, 0)
        return out


def _loop_details(item, out=None) -> List[str]:
    out = [] if out is None else out
    if isinstance(item, PlanLoop):
        n = sum(1 for b in item.body if isinstance(b, Superstep))
        out.append(
            f"loop#{item.iter_index}: {n} supersteps/iter "
            f"(fused={item.fused})"
        )
        for b in item.body:
            _loop_details(b, out)
    return out


def iter_nodes(prog: ast.Prog) -> List[ast.Iter]:
    """Pre-order list of Iter nodes — the iteration-counter index order
    shared by the compiler's trips vector and the cost models."""
    out: List[ast.Iter] = []

    def go(p):
        if isinstance(p, ast.Seq):
            for q in p.progs:
                go(q)
        elif isinstance(p, ast.Iter):
            out.append(p)
            go(p.body)

    go(prog)
    return out


def lower_program(
    prog: ast.Prog,
    schedule: str = "pull",
    byte_costs: Optional[ByteCostModel] = None,
) -> ProgramPlan:
    """Lower a whole Palgol program to its (unfused) :class:`ProgramPlan`:
    one single-part :class:`Superstep` per plan op — exactly the expansion
    the staged executor has always dispatched. Apply :func:`fuse` for the
    §4.3-optimized schedule."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; expected one of {SCHEDULES}"
        )
    loop_idx = {id(node): i for i, node in enumerate(iter_nodes(prog))}
    sidx = [0]
    plans: List[Tuple[ast.Step, StepPlan]] = []

    def lower(p) -> List[object]:
        if isinstance(p, ast.Step):
            plan = lower_step(p, schedule=schedule, byte_costs=byte_costs)
            si = sidx[0]
            sidx[0] += 1
            plans.append((p, plan))
            return [
                Superstep((OpRef(op, plan, si),), head=(i == 0))
                for i, op in enumerate(plan.ops)
            ]
        if isinstance(p, ast.StopStep):
            return [Superstep((OpRef(StopOp(p)),), head=True)]
        if isinstance(p, ast.Seq):
            out: List[object] = []
            for q in p.progs:
                out.extend(lower(q))
            return out
        if isinstance(p, ast.Iter):
            body = lower(p.body)
            return [
                Superstep((OpRef(IterInit()),), head=True),
                PlanLoop(tuple(body), p, loop_idx[id(p)], fused=False),
            ]
        raise TypeError(f"unknown program node {type(p).__name__}")

    items = tuple(lower(prog))
    return ProgramPlan(
        prog=prog,
        schedule=schedule,
        items=items,
        fused=False,
        step_plans=tuple(plans),
    )


def _op_writes(ref: OpRef) -> frozenset:
    """Fields the op writes within its superstep."""
    op = ref.op
    if isinstance(op, MainCompute):
        return frozenset(ref.plan.info.local_write_fields)
    if isinstance(op, RemoteUpdate):
        return frozenset(f for f, _ in op.writes)
    if isinstance(op, StopOp):
        return frozenset((HALTED,))
    return frozenset()  # ReadRound / IterInit: mailbox only


def _round_reads(ref: OpRef) -> frozenset:
    """Fields whose pre-superstep values a ReadRound's gathers/sends read
    (every field named in its chain / neighborhood / address patterns;
    general computed-index reads over-approximate to the step's full read
    set — the safe direction: a too-big set only withholds a merge)."""
    op = ref.op
    fields = set()
    for ce in op.chains:
        fields.update(ce.pattern)
    for _, pat in op.nbr_sends:
        fields.update(pat)
    for s in op.sends:
        fields.update(s.target)
        fields.update(s.expr)
        fields.update(s.via)
    if op.general and ref.plan is not None:
        fields.update(ref.plan.info.fields_read)
    return frozenset(fields)


def _merge_ok(prev: Superstep, nxt: Superstep) -> bool:
    """§4.3.1 state-merging legality at a program-node boundary.

    The paper's condition is message independence: the next node's first
    superstep must not consume messages produced inside the merged
    superstep. A leading MainCompute (a step with no remote reads), a
    StopStep, or an iteration Init consumes no messages — they merge
    unconditionally. A leading ReadRound *initiates* communication whose
    request set / payload is read from field state; we additionally require
    its read set to be disjoint from everything the previous superstep
    writes, so every fused op's outgoing communication is derivable from
    pre-superstep state (the conservative refinement that keeps merged
    collectives combinable in the partitioned executor)."""
    first = nxt.parts[0]
    if not isinstance(first.op, ReadRound):
        return True
    writes = frozenset().union(*(_op_writes(p) for p in prev.parts))
    return not (writes & _round_reads(first))


def fuse(pp: ProgramPlan) -> ProgramPlan:
    """The §4.3 optimization pass, applied for real.

    * **state merging** (§4.3.1): at every program-node boundary, the
      previous node's trailing superstep absorbs the next node's first
      superstep when :func:`_merge_ok` holds (merges chain, so a run of
      one-superstep steps collapses into one superstep);
    * **iteration fusion** (§4.3.2): a loop whose body begins with a
      ReadRound has that round duplicated into the preceding superstep
      (the prefetch) and merged into the body's last superstep — the
      loop-back edge overlaps the round with the previous iteration's
      tail, saving one superstep per iteration. The prefetch executes
      *after* the tail's ops, so it reads exactly the next iteration's
      input state; nested loops keep an explicit init (no fusion), as in
      the paper.

    Executors walk the returned plan directly; since parts stay in
    primitive-op order, fused execution is the unfused op sequence with
    different dispatch boundaries (plus one discarded trailing prefetch
    per fused loop) — bit-identical results, fewer supersteps.
    """

    def fuse_items(items) -> List[object]:
        out: List[object] = []
        for it in items:
            if isinstance(it, PlanLoop):
                body = fuse_items(list(it.body))
                fused_loop = False
                if (
                    not any(isinstance(b, PlanLoop) for b in body)
                    and len(body) >= 2
                    and isinstance(body[0], Superstep)
                    and len(body[0].parts) == 1
                    and isinstance(body[0].parts[0].op, ReadRound)
                    and out
                    and isinstance(out[-1], Superstep)
                ):
                    s1 = body[0].parts[0]
                    last = body[-1]
                    body = body[1:-1] + [
                        Superstep(last.parts + (s1,), last.head)
                    ]
                    out[-1] = Superstep(out[-1].parts + (s1,), out[-1].head)
                    fused_loop = True
                out.append(
                    dataclasses.replace(
                        it, body=tuple(body), fused=fused_loop
                    )
                )
            else:
                if (
                    out
                    and isinstance(out[-1], Superstep)
                    and it.head
                    and _merge_ok(out[-1], it)
                ):
                    out[-1] = Superstep(
                        out[-1].parts + it.parts, out[-1].head
                    )
                else:
                    out.append(it)
        return out

    return dataclasses.replace(
        pp, items=tuple(fuse_items(list(pp.items))), fused=True
    )
