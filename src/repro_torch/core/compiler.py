"""Palgol program compilation: AST → eager torch program + STM cost models.

The port of ``repro.core.compiler``. ``compile_program`` produces a
:class:`CompiledProgram` whose ``fn`` walks the (by default fused) program
plan eagerly on the graph's device: superstep parts run in plan order
against the program-level mailbox, and a fixed-point loop checks its
any-changed reduction (Pregel's OR aggregator) on the host after every
trip. ``trips`` counts body executions per iteration node so the STM cost
models report superstep totals for the paper's Table-5 accounting.

Fields the program creates are discovered by one abstract pass over
``meta`` tensors, where the ops take their plain versions: it computes
shapes and dtypes only, no values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import ast
from repro_torch.core import parser as palgol_parser
from repro_torch.core import plan as plan_mod
from repro_torch.core import stm as stm_mod
from repro_torch.core.analysis import CompileError, iter_steps
from repro_torch.core.codegen import HALTED, StepExecutor, exec_plan_part, make_stop_fn
from repro_torch.core.plan import ByteCostModel, SCHEDULES, lower_step
from repro_torch.graph.structure import as_field

# pre-order Iter list — the shared iteration-counter index order
_iter_nodes = plan_mod.iter_nodes


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Shape and dtype of one field (``jax.ShapeDtypeStruct``'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class CompiledProgram:
    prog: ast.Prog
    graph: object
    field_struct: Dict[str, FieldSpec]
    n_iters: int
    max_iters: int
    cost_models: Dict[str, stm_mod.CostModel]
    # chain-access schedule ("pull" | "push" | "naive" | "auto"); None
    # means "pull"
    schedule: Optional[str] = None
    # per-round byte estimates feeding the byte-aware ``auto`` selector
    byte_costs: Optional[ByteCostModel] = None
    # apply the §4.3 fuse pass to the program plan ``fn`` walks
    fuse: bool = True

    def step_plans(self, schedule: Optional[str] = None) -> List[tuple]:
        """``(step, StepPlan)`` for every Step node, in program order."""
        sched = (schedule if schedule is not None else self.schedule) or "pull"
        return [
            (s, lower_step(s, schedule=sched, byte_costs=self.byte_costs))
            for s in iter_steps(self.prog)
            if isinstance(s, ast.Step)
        ]

    def program_plan(
        self,
        schedule: Optional[str] = None,
        fuse: Optional[bool] = None,
    ) -> plan_mod.ProgramPlan:
        """The whole-program superstep schedule ``fn`` executes — fused by
        default (§4.3 state merging + iteration fusion)."""
        sched = (schedule if schedule is not None else self.schedule) or "pull"
        pp = plan_mod.lower_program(
            self.prog, schedule=sched, byte_costs=self.byte_costs
        )
        if self.fuse if fuse is None else fuse:
            pp = plan_mod.fuse(pp)
        return pp

    def init_fields(self, user_fields: Optional[Dict[str, object]] = None):
        """Canonical field dict on the graph's device: user fields + zeros
        for created fields."""
        device = self.graph.device
        fields = {}
        user_fields = user_fields or {}
        for name, spec in self.field_struct.items():
            if name in user_fields:
                arr = as_field(user_fields[name], device)
                if tuple(arr.shape) != spec.shape or arr.dtype != spec.dtype:
                    arr = arr.expand(spec.shape).to(spec.dtype).contiguous()
                fields[name] = arr
            else:
                fields[name] = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        for name in user_fields:
            if name not in fields:
                fields[name] = as_field(user_fields[name], device)
        return fields

    def fn(self, fields: Dict[str, torch.Tensor]):
        """Program function: fields → (fields, trips per iteration node).

        Walks the (by default fused) :class:`~repro_torch.core.plan.ProgramPlan`
        eagerly: superstep parts execute in plan order against the
        program-level mailbox, and a fused loop's prefetched ReadRound
        buffers stay in the mailbox across trips — the loop-back edge of
        §4.3.2 iteration fusion.
        """
        graph = self.graph
        pp = self.program_plan()
        trips = [0] * max(self.n_iters, 1)

        def run_items(items, flds, mailbox):
            for it in items:
                if isinstance(it, plan_mod.Superstep):
                    for ref in it.parts:
                        flds, mailbox = exec_plan_part(ref, graph, None, flds, mailbox)
                    continue
                fix = it.node.fix_fields
                limit = (
                    it.node.fixed_trips
                    if it.node.fixed_trips is not None
                    else self.max_iters
                )
                for name in fix:
                    if name not in flds:
                        raise CompileError(f"fix field {name!r} undefined")
                for _ in range(limit):
                    new_f, mailbox = run_items(it.body, flds, mailbox)
                    trips[it.iter_index] += 1
                    # host-side OR aggregator; fixed-trip loops run on
                    changed = not fix or any(
                        bool(torch.any(new_f[name] != flds[name])) for name in fix
                    )
                    flds = new_f
                    if not changed:
                        break
            return flds, mailbox

        out_fields, _ = run_items(pp.items, dict(fields), {})
        return out_fields, trips

    def run(self, user_fields: Optional[Dict[str, object]] = None):
        """Execute; returns (fields, trips, superstep counts per regime)."""
        fields = self.init_fields(user_fields)
        out, trips = self.fn(fields)
        counts = {name: cm.count(trips) for name, cm in self.cost_models.items()}
        return out, trips, counts


def _discover_fields(prog, graph, fields_struct: Dict[str, FieldSpec]):
    """Abstract pass on ``meta`` tensors discovering created fields and
    stable dtypes."""
    meta_graph = graph.to("meta")

    def abstract(fs):
        return {
            k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in fs.items()
        }

    def specs(flds):
        return {k: FieldSpec(tuple(v.shape), v.dtype) for k, v in flds.items()}

    def step_pass(step, fs):
        # field discovery is schedule-independent — pin pull
        ex = StepExecutor(step, meta_graph, schedule="pull")
        return specs(ex(abstract(fs)))

    def stop_pass(stop, fs):
        return specs(make_stop_fn(stop, meta_graph)(abstract(fs)))

    def go(p, fs):
        if isinstance(p, ast.Step):
            return step_pass(p, fs)
        if isinstance(p, ast.StopStep):
            return stop_pass(p, fs)
        if isinstance(p, ast.Seq):
            for q in p.progs:
                fs = go(q, fs)
            return fs
        if isinstance(p, ast.Iter):
            fs2 = go(p.body, fs)
            # one more pass with the enriched struct: dtypes must be stable
            fs3 = go(p.body, fs2)
            if fs2 != fs3:
                raise CompileError(
                    "iteration body changes field shapes/dtypes between "
                    "iterations — not expressible as a fixed carry"
                )
            return fs2
        raise CompileError(f"unknown program node {type(p).__name__}")

    return go(prog, dict(fields_struct))


def compile_program(
    source_or_ast: Union[str, ast.Prog],
    graph,
    initial_fields: Optional[Dict[str, object]] = None,
    max_iters: int = 100_000,
    schedule: Optional[str] = None,
    byte_costs: Optional[ByteCostModel] = None,
    fuse: bool = True,
) -> CompiledProgram:
    """Compile Palgol source (or AST) against a graph; the program runs on
    the graph's device (``cuda`` unless the graph was built elsewhere).

    ``initial_fields`` supplies dtypes/values of pre-existing fields; fields
    created by the program (via ``local F[v] := ...``) are discovered by an
    abstract pass and zero-initialized. ``schedule`` selects the
    chain-access lowering (``"pull"``, ``"push"``, ``"naive"``, ``"auto"``;
    ``None`` means ``"pull"``); ``byte_costs`` makes ``"auto"`` select on
    the byte model; ``fuse`` (default True) applies the §4.3 program-level
    optimizations to the plan ``fn`` walks.
    """
    prog = (
        palgol_parser.parse(source_or_ast)
        if isinstance(source_or_ast, str)
        else source_or_ast
    )
    if schedule is not None and schedule not in SCHEDULES:
        raise CompileError(
            f"unknown schedule {schedule!r}; expected one of {SCHEDULES}"
        )
    n = graph.n_vertices
    fs: Dict[str, FieldSpec] = {HALTED: FieldSpec((n,), torch.bool)}
    for name, arr in (initial_fields or {}).items():
        arr = as_field(arr, arr.device if isinstance(arr, torch.Tensor) else "cpu")
        fs[name] = FieldSpec(tuple(arr.shape), arr.dtype)
    field_struct = _discover_fields(prog, graph, fs)
    cost_models = stm_mod.superstep_report(prog, byte_costs=byte_costs)
    return CompiledProgram(
        prog=prog,
        graph=graph,
        field_struct=field_struct,
        n_iters=len(_iter_nodes(prog)),
        max_iters=max_iters,
        cost_models=cost_models,
        schedule=schedule,
        byte_costs=byte_costs,
        fuse=fuse,
    )
