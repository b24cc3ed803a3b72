"""Palgol abstract syntax (paper Fig. 2, plus the §3.4 inactivation step).

The AST is deliberately small and immutable. Conventions:
* ``var``   — lowercase identifiers (vertex/edge/let variables)
* ``field`` — capitalized identifiers (global per-vertex arrays)
* Edge lists ``Nbr``/``In``/``Out`` are fields of a predefined edge type and
  only appear as the range of comprehensions / for-loops.
* Local writes: ``:=``, ``+=``, ``*=``, ``<?=`` (min), ``>?=`` (max),
  ``||=``, ``&&=``. Remote writes: accumulative only (everything but ``:=``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# expressions


class Expr:
    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: object  # int | float | bool | "inf"

    def __repr__(self):
        return f"Const({self.value!r})"


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    name: str


@dataclasses.dataclass(frozen=True)
class FieldAccess(Expr):
    """``Field [ exp ]`` — a global field read (possibly remote)."""

    field: str
    index: Expr


@dataclasses.dataclass(frozen=True)
class EdgeProp(Expr):
    """``e.id`` / ``e.w`` on an edge-loop variable."""

    edge_var: str
    prop: str  # "id" | "w"


@dataclasses.dataclass(frozen=True)
class Cond(Expr):
    cond: Expr
    then: Expr
    other: Expr


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / % == != < <= > >= && ||
    left: Expr
    right: Expr


@dataclasses.dataclass(frozen=True)
class UnOp(Expr):
    op: str  # ! -
    operand: Expr


@dataclasses.dataclass(frozen=True)
class EdgeList(Expr):
    """``Nbr[v]`` / ``In[v]`` / ``Out[v]`` — only as comprehension range."""

    direction: str  # "nbr" | "in" | "out"
    vertex: Expr


@dataclasses.dataclass(frozen=True)
class Reduce(Expr):
    """``func [ body | e <- range, filter_1, ..., filter_k ]``.

    ``func`` ∈ {minimum, maximum, sum, prod, and, or, count}; ``count`` is
    sugar for ``sum [1 | ...]``. ``argmin``/``argmax`` return the ``e.id`` of
    a minimizing/maximizing edge (used by matching algorithms).
    """

    func: str
    body: Expr
    edge_var: str
    range: EdgeList
    filters: Tuple[Expr, ...] = ()


# ---------------------------------------------------------------------------
# statements


class Stmt:
    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Let(Stmt):
    var: str
    value: Expr


@dataclasses.dataclass(frozen=True)
class If(Stmt):
    cond: Expr
    then: Tuple[Stmt, ...]
    other: Tuple[Stmt, ...] = ()


@dataclasses.dataclass(frozen=True)
class ForEdges(Stmt):
    """``for (e <- Nbr[v]) <block>`` — non-nested edge loop."""

    edge_var: str
    range: EdgeList
    body: Tuple[Stmt, ...]


@dataclasses.dataclass(frozen=True)
class LocalWrite(Stmt):
    """``local Field[v] op exp`` — v must be the current vertex."""

    field: str
    op: str  # ":=" "+=" "*=" "<?=" ">?=" "||=" "&&="
    value: Expr
    index_var: str = ""  # must name the step's vertex var (checked in analysis)


@dataclasses.dataclass(frozen=True)
class RemoteWrite(Stmt):
    """``remote Field[exp] op exp`` — accumulative op only."""

    field: str
    target: Expr
    op: str  # "+=" "*=" "<?=" ">?=" "||=" "&&="
    value: Expr


# ---------------------------------------------------------------------------
# programs


class Prog:
    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Step(Prog):
    """``for var in V <block> end`` — one algorithmic superstep."""

    vertex_var: str
    body: Tuple[Stmt, ...]


@dataclasses.dataclass(frozen=True)
class StopStep(Prog):
    """``stop var in V if exp`` — vertex inactivation (paper §3.4)."""

    vertex_var: str
    cond: Expr


@dataclasses.dataclass(frozen=True)
class Seq(Prog):
    progs: Tuple[Prog, ...]


@dataclasses.dataclass(frozen=True)
class Iter(Prog):
    """``do <prog> until fix [F1, ..., Fn]`` or ``until iter [k]``.

    The paper focuses on fixed-point termination but notes Palgol supports
    several kinds; fixed-trip-count iteration (``iter [k]``) is the one
    PageRank-style algorithms need.
    """

    body: Prog
    fix_fields: Tuple[str, ...]
    fixed_trips: Optional[int] = None


Program = Prog  # alias for readability at API boundaries


REMOTE_OPS = {"+=", "*=", "<?=", ">?=", "||=", "&&="}
LOCAL_OPS = {":="} | REMOTE_OPS
OP_TO_COMBINER = {
    "+=": "sum",
    "*=": "prod",
    "<?=": "min",
    ">?=": "max",
    "||=": "or",
    "&&=": "and",
}
REDUCE_FUNCS = {"minimum", "maximum", "sum", "prod", "and", "or", "count",
                "argmin", "argmax"}


def walk_exprs(node):
    """Yield every Expr reachable from an Expr/Stmt/Prog node."""
    if isinstance(node, Expr):
        yield node
        children = {
            Const: (),
            Var: (),
            EdgeProp: (),
            FieldAccess: (node.index,) if isinstance(node, FieldAccess) else (),
            Cond: (node.cond, node.then, node.other) if isinstance(node, Cond) else (),
            BinOp: (node.left, node.right) if isinstance(node, BinOp) else (),
            UnOp: (node.operand,) if isinstance(node, UnOp) else (),
            EdgeList: (node.vertex,) if isinstance(node, EdgeList) else (),
            Reduce: ((node.body, node.range) + node.filters)
            if isinstance(node, Reduce)
            else (),
        }[type(node)]
        for c in children:
            yield from walk_exprs(c)
    elif isinstance(node, Let):
        yield from walk_exprs(node.value)
    elif isinstance(node, If):
        yield from walk_exprs(node.cond)
        for s in node.then + node.other:
            yield from walk_exprs(s)
    elif isinstance(node, ForEdges):
        yield from walk_exprs(node.range)
        for s in node.body:
            yield from walk_exprs(s)
    elif isinstance(node, LocalWrite):
        yield from walk_exprs(node.value)
    elif isinstance(node, RemoteWrite):
        yield from walk_exprs(node.target)
        yield from walk_exprs(node.value)
    elif isinstance(node, Step):
        for s in node.body:
            yield from walk_exprs(s)
    elif isinstance(node, StopStep):
        yield from walk_exprs(node.cond)
    elif isinstance(node, Seq):
        for p in node.progs:
            yield from walk_exprs(p)
    elif isinstance(node, Iter):
        yield from walk_exprs(node.body)


def walk_stmts(stmts):
    """Yield statements recursively (pre-order)."""
    for s in stmts:
        yield s
        if isinstance(s, If):
            yield from walk_stmts(s.then)
            yield from walk_stmts(s.other)
        elif isinstance(s, ForEdges):
            yield from walk_stmts(s.body)
