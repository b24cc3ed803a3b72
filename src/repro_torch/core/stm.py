"""State-transition-machine model of compiled Palgol programs (paper §4.2–4.3).

The STM is the *accounting* artifact: it records how many Pregel supersteps
the compiled program costs. Since the program-level plan IR landed
(:func:`repro.core.plan.lower_program` + :func:`repro.core.plan.fuse`),
this module derives **everything** from that IR — it contains no superstep
expansion and no merging/fusion logic of its own:

* ``optimize=False`` counts the unfused :class:`~repro.core.plan.ProgramPlan`
  (one superstep per plan op — what ``run_bsp(..., fuse=False)`` executes);
* ``optimize=True`` counts the :func:`~repro.core.plan.fuse`-rewritten plan
  (§4.3.1 state merging + §4.3.2 iteration fusion — what the executors
  dispatch by default), so optimized accounting equals optimized execution
  by construction.

``mode`` is the chain-access schedule (``pull``/``push``/``naive``/``auto``,
see :mod:`repro.core.plan`). Superstep count for a run is a *linear
functional* of the per-iteration trip counts:
``total = base + Σ_i per_iter_i × trips_i``; ``count()`` takes the measured
trip counts from execution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import ast
from repro_torch.core import plan as plan_mod


@dataclasses.dataclass(frozen=True)
class State:
    kind: str  # "read" | "main" | "update"
    label: str = ""
    merged: Tuple[str, ...] = ()  # labels merged into this superstep


@dataclasses.dataclass
class STM:
    """Linearized STM: prefix states + loops (each with body states/trips)."""

    states: List  # List[State | Loop]

    def total_states(self) -> int:
        n = 0
        for s in self.states:
            n += 1 if isinstance(s, State) else 0
        return n


@dataclasses.dataclass
class Loop:
    body: List[State]
    iter_index: int  # position in the program's iteration-counter vector
    fused: bool


@dataclasses.dataclass
class CostModel:
    """total supersteps = base + Σ per_iter[i] * trips[i]."""

    base: int
    per_iter: Dict[int, int]
    detail: List[str]

    def count(self, trips: Dict[int, int] | List[int]) -> int:
        if not isinstance(trips, dict):
            trips = dict(enumerate(trips))
        total = self.base
        for i, per in self.per_iter.items():
            total += per * int(trips.get(i, 0))
        return total


def _part_label(ref: plan_mod.OpRef, i: int) -> Tuple[str, str]:
    """(kind, label) of one superstep part, for the STM rendering."""
    op = ref.op
    if isinstance(op, plan_mod.ReadRound):
        return "read", f"rr{i}"
    if isinstance(op, plan_mod.RemoteUpdate):
        return "update", "ru"
    if isinstance(op, plan_mod.IterInit):
        return "main", "iter-init"
    if isinstance(op, plan_mod.StopOp):
        return "main", "stop"
    return "main", "main"


def _to_states(items) -> List:
    out: List = []
    for it in items:
        if isinstance(it, plan_mod.Superstep):
            kinds_labels = [
                _part_label(ref, i) for i, ref in enumerate(it.parts)
            ]
            kind, label = kinds_labels[0]
            merged = tuple(lbl for _, lbl in kinds_labels[1:])
            out.append(State(kind, label, merged=merged))
        else:
            out.append(Loop(_to_states(it.body), it.iter_index, it.fused))
    return out


def build_stm(
    prog: ast.Prog,
    mode: str = "push",
    optimize: bool = True,
    byte_costs: Optional[plan_mod.ByteCostModel] = None,
) -> Tuple[STM, CostModel]:
    """Build the STM and its superstep cost model off the program plan.

    ``optimize=True`` counts the fused plan (state merging + iteration
    fusion — the default execution schedule); ``optimize=False`` counts the
    unfused plan (``fuse=False`` execution / the manual-style baseline when
    combined with ``mode="naive"``). ``byte_costs`` only affects
    ``mode="auto"`` (byte-aware per-step selection, matching executors
    given the same costs).
    """
    pp = plan_mod.lower_program(prog, schedule=mode, byte_costs=byte_costs)
    if optimize:
        pp = plan_mod.fuse(pp)
    base, per_iter, detail = pp.cost()
    return STM(_to_states(pp.items)), CostModel(base, per_iter, detail)


def superstep_report(
    prog: ast.Prog,
    byte_costs: Optional[plan_mod.ByteCostModel] = None,
) -> Dict[str, CostModel]:
    """Cost models under the compilation regimes.

    * ``palgol_push``  — paper-faithful compiler output (push chain plans,
      state merging, iteration fusion) — what ``schedule="push"`` executes
      by default (``fuse=True``);
    * ``palgol_pull``  — this framework's dense schedule, fused — what
      ``schedule="pull"``/default executes (``fuse=True``);
    * ``pull_staged``  — pull schedule without merging/fusion (matches
      ``fuse=False`` execution on every executor);
    * ``push``         — push schedule, unfused (``schedule="push",
      fuse=False``);
    * ``naive``        — request/reply chains, no merging/fusion (the
      "straightforward"/manual baseline the paper compares against);
    * ``auto``         — per-step cheapest of pull/push/naive, unfused;
    * ``fused_pull`` / ``fused_push`` — aliases of the ``palgol_*`` keys;
    * ``fused_naive`` / ``fused_auto`` — the remaining schedules under the
      fuse pass, completing the (schedule × fuse) count matrix every
      ``run_bsp(schedule=s, fuse=f)`` cell can be checked against (pass the
      same ``byte_costs`` the executor got so ``auto`` lines up).
    """
    fused_pull = build_stm(prog, "pull", optimize=True)[1]
    fused_push = build_stm(prog, "push", optimize=True)[1]
    return {
        "palgol_push": fused_push,
        "palgol_pull": fused_pull,
        "pull_staged": build_stm(prog, "pull", optimize=False)[1],
        "push": build_stm(prog, "push", optimize=False)[1],
        "naive": build_stm(prog, "naive", optimize=False)[1],
        "auto": build_stm(
            prog, "auto", optimize=False, byte_costs=byte_costs
        )[1],
        "fused_pull": fused_pull,
        "fused_push": fused_push,
        "fused_naive": build_stm(prog, "naive", optimize=True)[1],
        "fused_auto": build_stm(
            prog, "auto", optimize=True, byte_costs=byte_costs
        )[1],
    }
