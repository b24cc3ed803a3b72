"""Static analysis of Palgol steps: remote-access patterns + validation.

Recognizes the two remote-read patterns of paper §4.1 —

* **chain access** — ``FieldAccess`` whose index bottoms out at the current
  vertex variable through nested field accesses (``D[D[u]]`` →
  pattern ``("D","D")``);
* **neighborhood communication** — chain accesses starting from ``e.id``
  inside an edge comprehension/loop (``D[e.id]`` → ``("D",)`` at the
  neighbor) —

plus *general reads* ``F[t]`` with a computed index (costed as one
request/reply in push mode, one gather in pull mode), and collects remote
writes and written fields. Also enforces the well-formedness rules the paper
bakes into its syntax (accumulative-only remote writes, non-nested edge
loops, local writes only to the current vertex).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core import ast
from repro_torch.core import logic


class CompileError(Exception):
    pass


@dataclasses.dataclass
class StepInfo:
    vertex_var: str
    # chain patterns evaluated in vertex context (key: pattern tuple)
    chain_patterns: Set[logic.Pattern] = dataclasses.field(default_factory=set)
    # neighborhood communications: (direction, pattern applied at neighbor)
    nbr_comms: Set[Tuple[str, logic.Pattern]] = dataclasses.field(default_factory=set)
    # number of general (non-chain) remote reads
    general_reads: int = 0
    remote_write_fields: Set[str] = dataclasses.field(default_factory=set)
    local_write_fields: Set[str] = dataclasses.field(default_factory=set)
    fields_read: Set[str] = dataclasses.field(default_factory=set)
    uses_edges: Set[str] = dataclasses.field(default_factory=set)  # directions

    # --- round counts (communication rounds before the main superstep) ----
    def push_read_rounds(self) -> int:
        """Paper-faithful: chain plans + neighborhood sends run in parallel
        (independent message flows share supersteps), so the read phase costs
        the max over individual plans."""
        rounds = 0
        solver = logic.PushSolver()
        for p in self.chain_patterns:
            rounds = max(rounds, solver.rounds(p))
        for _, p in self.nbr_comms:
            # evaluate the chain at the neighbor, then one send along edges
            rounds = max(rounds, solver.rounds(p) + 1 if len(p) > 1 else 1)
        if self.general_reads:
            rounds = max(rounds, 2)  # request + reply
        return rounds

    def pull_read_rounds(self) -> int:
        """Beyond-paper gather staging (one-sided reads)."""
        rounds = 0
        solver = logic.PullSolver()
        for p in self.chain_patterns:
            rounds = max(rounds, solver.rounds(p))
        for _, p in self.nbr_comms:
            rounds = max(rounds, solver.rounds(p) + 1)
        if self.general_reads:
            rounds = max(rounds, 1)
        return rounds

    def read_patterns(self) -> List[logic.Pattern]:
        """Chain patterns the read phase must materialize: vertex-context
        chains plus multi-hop neighborhood chains (evaluated at the
        neighbor before the send). The shared input of every schedule's
        lowering in :mod:`repro.core.plan`."""
        pats = set(self.chain_patterns)
        for _, npat in self.nbr_comms:
            if len(npat) > 1:
                pats.add(npat)
        return sorted(pats)

    def has_remote_writes(self) -> bool:
        return bool(self.remote_write_fields)


def chain_pattern_of(expr: ast.Expr, vertex_var: str) -> Optional[logic.Pattern]:
    """Return the chain pattern if ``expr`` is a consecutive field access
    starting from the current vertex (``u`` → ``()``, ``D[u]`` → ``("D",)``,
    ``D[D[u]]`` → ``("D","D")``), else None."""
    if isinstance(expr, ast.Var) and expr.name == vertex_var:
        return ()
    if isinstance(expr, ast.FieldAccess):
        inner = chain_pattern_of(expr.index, vertex_var)
        if inner is not None:
            return inner + (expr.field,)
    return None


def neighbor_pattern_of(expr: ast.Expr, edge_var: str) -> Optional[logic.Pattern]:
    """Chain pattern starting from ``e.id`` (neighborhood communication)."""
    if (
        isinstance(expr, ast.EdgeProp)
        and expr.edge_var == edge_var
        and expr.prop == "id"
    ):
        return ()
    if isinstance(expr, ast.FieldAccess):
        inner = neighbor_pattern_of(expr.index, edge_var)
        if inner is not None:
            return inner + (expr.field,)
    return None


def analyze_step(step: ast.Step) -> StepInfo:
    info = StepInfo(vertex_var=step.vertex_var)
    let_vars: Set[str] = set()
    remote_ops: Dict[str, str] = {}  # field → its (single) remote combiner

    def visit_expr(e: ast.Expr, edge_var: Optional[str], in_reduce: bool):
        if isinstance(e, ast.FieldAccess):
            info.fields_read.add(e.field)
            pat = chain_pattern_of(e, step.vertex_var)
            if pat is not None:
                if len(pat) > 1:
                    info.chain_patterns.add(pat)
                # len==1 ⇒ own-field read (axiom, free); sub-chains are part
                # of the pattern's plan — do not re-visit the index
                return
            if edge_var is not None:
                npat = neighbor_pattern_of(e, edge_var)
                if npat is not None:
                    info.nbr_comms.add((_current_dir[0], npat))
                    return
            # general read with a computed index
            info.general_reads += 1
            visit_expr(e.index, edge_var, in_reduce)
            return
        if isinstance(e, ast.Var):
            if (
                e.name != step.vertex_var
                and e.name not in let_vars
                and e.name != edge_var
                and e.name != "numV"  # builtin vertex-count constant
            ):
                raise CompileError(f"unbound variable {e.name!r}")
            return
        if isinstance(e, ast.EdgeProp):
            if e.edge_var != edge_var:
                raise CompileError(
                    f".{e.prop} used on {e.edge_var!r} outside its edge loop"
                )
            return
        if isinstance(e, ast.Reduce):
            if in_reduce or edge_var is not None:
                raise CompileError("nested edge comprehensions are not supported")
            _check_edge_range(e.range, step.vertex_var)
            info.uses_edges.add(e.range.direction)
            _current_dir[0] = e.range.direction
            visit_expr(e.body, e.edge_var, True)
            for f in e.filters:
                visit_expr(f, e.edge_var, True)
            _current_dir[0] = None
            return
        if isinstance(e, ast.EdgeList):
            raise CompileError("edge list used outside comprehension/loop range")
        if isinstance(e, ast.Cond):
            visit_expr(e.cond, edge_var, in_reduce)
            visit_expr(e.then, edge_var, in_reduce)
            visit_expr(e.other, edge_var, in_reduce)
            return
        if isinstance(e, ast.BinOp):
            visit_expr(e.left, edge_var, in_reduce)
            visit_expr(e.right, edge_var, in_reduce)
            return
        if isinstance(e, ast.UnOp):
            visit_expr(e.operand, edge_var, in_reduce)
            return
        if isinstance(e, ast.Const):
            return
        raise CompileError(f"unknown expression node {type(e).__name__}")

    _current_dir: List[Optional[str]] = [None]

    def visit_stmts(stmts, edge_var: Optional[str]):
        for s in stmts:
            if isinstance(s, ast.Let):
                visit_expr(s.value, edge_var, False)
                let_vars.add(s.var)
            elif isinstance(s, ast.If):
                visit_expr(s.cond, edge_var, False)
                visit_stmts(s.then, edge_var)
                visit_stmts(s.other, edge_var)
            elif isinstance(s, ast.ForEdges):
                if edge_var is not None:
                    raise CompileError("nested edge loops are not supported")
                _check_edge_range(s.range, step.vertex_var)
                info.uses_edges.add(s.range.direction)
                _current_dir[0] = s.range.direction
                visit_stmts(s.body, s.edge_var)
                _current_dir[0] = None
            elif isinstance(s, ast.LocalWrite):
                if s.index_var and s.index_var != step.vertex_var:
                    raise CompileError(
                        f"local write indexes {s.index_var!r}, not the current "
                        f"vertex {step.vertex_var!r} — use `remote` for that"
                    )
                if edge_var is not None and s.op == ":=":
                    raise CompileError(
                        "plain `:=` inside an edge loop is order-dependent; "
                        "use an accumulative op"
                    )
                visit_expr(s.value, edge_var, False)
                info.local_write_fields.add(s.field)
            elif isinstance(s, ast.RemoteWrite):
                if s.op not in ast.REMOTE_OPS:
                    raise CompileError(f"remote write op {s.op!r} not accumulative")
                prev = remote_ops.get(s.field)
                if prev is not None and prev != s.op:
                    # the paper's order-independence guarantee only holds
                    # when all remote writes to a field share one combiner;
                    # mixing (e.g. += then <?=) is order-dependent — reject
                    raise CompileError(
                        f"field {s.field!r} receives remote writes with "
                        f"mixed combiners ({prev!r} and {s.op!r}) in one "
                        "step — order-dependent, not allowed"
                    )
                remote_ops[s.field] = s.op
                visit_expr(s.target, edge_var, False)
                visit_expr(s.value, edge_var, False)
                info.remote_write_fields.add(s.field)
            else:
                raise CompileError(f"unknown statement {type(s).__name__}")

    visit_stmts(step.body, None)
    return info


def _check_edge_range(rng: ast.EdgeList, vertex_var: str):
    if not (isinstance(rng.vertex, ast.Var) and rng.vertex.name == vertex_var):
        raise CompileError(
            "edge lists may only be traversed from the current vertex "
            f"({vertex_var!r})"
        )


def iter_steps(prog: ast.Prog):
    """Yield all Step/StopStep nodes of a program."""
    if isinstance(prog, (ast.Step, ast.StopStep)):
        yield prog
    elif isinstance(prog, ast.Seq):
        for p in prog.progs:
            yield from iter_steps(p)
    elif isinstance(prog, ast.Iter):
        yield from iter_steps(prog.body)
    else:
        raise CompileError(f"unknown program node {type(prog).__name__}")


def program_fields(prog: ast.Prog) -> Tuple[Set[str], Set[str]]:
    """(fields read, fields written) over the whole program."""
    read: Set[str] = set()
    written: Set[str] = set()
    for step in iter_steps(prog):
        if isinstance(step, ast.StopStep):
            for e in ast.walk_exprs(step.cond):
                if isinstance(e, ast.FieldAccess):
                    read.add(e.field)
            continue
        inf = analyze_step(step)
        read |= inf.fields_read
        written |= inf.local_write_fields | inf.remote_write_fields
    return read, written
