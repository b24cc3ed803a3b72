"""Naive reference interpreter — the semantic oracle for the compiler.

Executes Palgol programs one vertex at a time in pure Python/numpy, directly
following the paper's §3.1 semantics:

* LC phase: every vertex runs the block; reads see the *input* fields; local
  writes read-modify-write an intermediate copy of the vertex's own row;
* RU phase: remote accumulative writes collected during LC are applied to the
  intermediate copy (order-independent by construction);
* fixed-point iteration repeats until the fix fields stabilize;
* halted vertices skip computation and reject incoming remote writes, but
  remain readable.

This is O(V·E) Python — only for small test graphs. The property tests
(hypothesis) compare the dense compiled executor against this oracle on
random graphs and random programs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import ast
from repro_torch.core import parser as palgol_parser
from repro_torch.core.analysis import CompileError

_IDENT = {
    "minimum": math.inf,
    "maximum": -math.inf,
    "sum": 0,
    "prod": 1,
    "and": True,
    "or": False,
}

_INT_IDENT = {"minimum": np.iinfo(np.int32).max, "maximum": np.iinfo(np.int32).min}


class _Adjacency:
    """Host-side adjacency lists built from the dense Graph struct."""

    def __init__(self, graph):
        self.n = graph.n_vertices
        src = np.asarray(graph.src)
        dst = np.asarray(graph.dst)
        w = np.asarray(graph.weight)
        m = np.asarray(graph.edge_mask)
        self.in_adj: List[List[Tuple[int, float]]] = [[] for _ in range(self.n)]
        self.out_adj: List[List[Tuple[int, float]]] = [[] for _ in range(self.n)]
        for s, d, ww, mm in zip(src, dst, w, m):
            if not mm:
                continue
            self.in_adj[d].append((int(s), float(ww)))
            self.out_adj[s].append((int(d), float(ww)))

    def edges(self, direction: str, u: int):
        if direction in ("in", "nbr"):
            return self.in_adj[u]
        return self.out_adj[u]


def interpret(
    source_or_ast,
    graph,
    initial_fields: Optional[Dict[str, np.ndarray]] = None,
    max_iters: int = 100_000,
):
    """Run the oracle; returns (fields dict of numpy arrays, trips list)."""
    prog = (
        palgol_parser.parse(source_or_ast)
        if isinstance(source_or_ast, str)
        else source_or_ast
    )
    adj = _Adjacency(graph)
    n = adj.n
    fields: Dict[str, np.ndarray] = {"_halted": np.zeros(n, bool)}
    for name, arr in (initial_fields or {}).items():
        fields[name] = np.array(arr)
    trips: List[int] = []

    def field_read(flds, name, idx):
        if name == "Id":
            return int(idx)
        if name not in flds:
            raise CompileError(f"read of undefined field {name!r}")
        i = int(idx)
        if i < 0 or i >= n:
            i = min(max(i, 0), n - 1)  # clip, matching dense gather
        return flds[name][i]

    def eval_expr(e, u, env, old):
        if isinstance(e, ast.Const):
            return math.inf if e.value == "inf" else e.value
        if isinstance(e, ast.Var):
            if e.name == "numV":
                return n
            return env[e.name]
        if isinstance(e, ast.EdgeProp):
            nbr, w = env[("edge", e.edge_var)]
            return nbr if e.prop == "id" else w
        if isinstance(e, ast.FieldAccess):
            idx = eval_expr(e.index, u, env, old)
            return field_read(old, e.field, idx)
        if isinstance(e, ast.Cond):
            return (
                eval_expr(e.then, u, env, old)
                if eval_expr(e.cond, u, env, old)
                else eval_expr(e.other, u, env, old)
            )
        if isinstance(e, ast.BinOp):
            lhs = eval_expr(e.left, u, env, old)
            rhs = eval_expr(e.right, u, env, old)
            return _apply_binop(e.op, lhs, rhs)
        if isinstance(e, ast.UnOp):
            x = eval_expr(e.operand, u, env, old)
            return (not x) if e.op == "!" else -x
        if isinstance(e, ast.Reduce):
            items = []
            # identity dtype must come from *static* typing, not from the
            # (possibly empty) item list — mirrors the dense executor, where
            # the segment-reduce identity is the field dtype's inf/intmax.
            int_valued = not _is_float_expr(e.body, old, env)
            for nbr, w in adj.edges(e.range.direction, u):
                env2 = dict(env)
                env2[("edge", e.edge_var)] = (nbr, w)
                env2[e.edge_var] = None  # marks the loop var as bound
                if all(eval_expr(f, u, env2, old) for f in e.filters):
                    if e.func == "count":
                        items.append(1)
                    elif e.func in ("argmin", "argmax"):
                        items.append((eval_expr(e.body, u, env2, old), nbr))
                    else:
                        items.append(eval_expr(e.body, u, env2, old))
            return _reduce(e.func, items, int_valued, sentinel=n)
        raise CompileError(f"cannot evaluate {type(e).__name__}")

    def exec_stmts(stmts, u, env, old, new, remote_msgs, edge_ctx):
        for s in stmts:
            if isinstance(s, ast.Let):
                env[s.var] = eval_expr(s.value, u, env, old)
            elif isinstance(s, ast.If):
                if eval_expr(s.cond, u, env, old):
                    exec_stmts(s.then, u, env, old, new, remote_msgs, edge_ctx)
                elif s.other:
                    exec_stmts(s.other, u, env, old, new, remote_msgs, edge_ctx)
            elif isinstance(s, ast.ForEdges):
                for nbr, w in adj.edges(s.range.direction, u):
                    env2 = dict(env)
                    env2[("edge", s.edge_var)] = (nbr, w)
                    exec_stmts(s.body, u, env2, old, new, remote_msgs, True)
            elif isinstance(s, ast.LocalWrite):
                val = eval_expr(s.value, u, env, old)
                if s.field not in new:
                    if s.op != ":=":
                        raise CompileError(
                            f"field {s.field!r} first written accumulatively"
                        )
                    # dtype from the *expression* (matches jnp promotion in
                    # the dense executor), not this vertex's branch value:
                    # `(Id[v]==0 ? 0 : inf)` is float even where it yields 0
                    if _is_float_expr(s.value, old, env):
                        dtype = np.float32
                    else:
                        dtype = _infer_dtype(val)
                    new[s.field] = np.zeros(n, dtype)
                    old.setdefault(s.field, np.zeros(n, dtype))
                cur = new[s.field][u]
                new[s.field][u] = _apply_write(s.op, cur, val, new[s.field].dtype)
            elif isinstance(s, ast.RemoteWrite):
                tgt = int(eval_expr(s.target, u, env, old))
                val = eval_expr(s.value, u, env, old)
                remote_msgs.append((s.field, s.op, tgt, val))
            else:
                raise CompileError(f"unknown statement {type(s).__name__}")

    def run_step(step: ast.Step):
        old = {k: v.copy() for k, v in fields.items()}
        new = {k: v.copy() for k, v in fields.items()}
        remote_msgs: List[Tuple[str, str, int, object]] = []
        halted = fields["_halted"]
        for u in range(n):
            if halted[u]:
                continue
            env = {step.vertex_var: u}
            exec_stmts(step.body, u, env, old, new, remote_msgs, False)
        for f, op, tgt, val in remote_msgs:
            if tgt < 0 or tgt >= n or halted[tgt]:
                continue
            if f not in new:
                raise CompileError(f"remote write to undefined field {f!r}")
            cur = new[f][tgt]
            new[f][tgt] = _apply_write(op, cur, val, new[f].dtype)
        fields.clear()
        fields.update(new)

    def run_stop(stop: ast.StopStep):
        old = {k: v.copy() for k, v in fields.items()}
        halted = fields["_halted"].copy()
        for u in range(n):
            if halted[u]:
                continue
            env = {stop.vertex_var: u}
            if eval_expr(stop.cond, u, env, old):
                halted[u] = True
        fields["_halted"] = halted

    def run(p):
        if isinstance(p, ast.Step):
            run_step(p)
        elif isinstance(p, ast.StopStep):
            run_stop(p)
        elif isinstance(p, ast.Seq):
            for q in p.progs:
                run(q)
        elif isinstance(p, ast.Iter):
            trips.append(0)
            slot = len(trips) - 1
            limit = p.fixed_trips if p.fixed_trips is not None else max_iters
            for _ in range(limit):
                before = {f: fields[f].copy() for f in p.fix_fields if f in fields}
                run(p.body)
                trips[slot] += 1
                if p.fix_fields:
                    stable = all(
                        f in before and np.array_equal(before[f], fields[f])
                        for f in p.fix_fields
                    )
                    if stable:
                        break
        else:
            raise CompileError(f"unknown program node {type(p).__name__}")

    run(prog)
    return fields, trips


def _is_float_expr(e, fields, env) -> bool:
    """Static-ish float-ness of a reduce body (for the empty-list identity)."""
    if isinstance(e, ast.Const):
        return isinstance(e.value, float) or e.value == "inf"
    if isinstance(e, ast.Var):
        v = env.get(e.name)
        return isinstance(v, (float, np.floating))
    if isinstance(e, ast.EdgeProp):
        return e.prop == "w"
    if isinstance(e, ast.FieldAccess):
        arr = fields.get(e.field)
        return arr is not None and np.issubdtype(arr.dtype, np.floating)
    if isinstance(e, ast.Cond):
        return _is_float_expr(e.then, fields, env) or _is_float_expr(
            e.other, fields, env
        )
    if isinstance(e, ast.BinOp):
        if e.op == "/":
            return True
        if e.op in ("==", "!=", "<", "<=", ">", ">=", "&&", "||"):
            return False
        return _is_float_expr(e.left, fields, env) or _is_float_expr(
            e.right, fields, env
        )
    if isinstance(e, ast.UnOp):
        return e.op != "!" and _is_float_expr(e.operand, fields, env)
    return False


def _infer_dtype(val):
    if isinstance(val, (bool, np.bool_)):
        return np.bool_
    if isinstance(val, (int, np.integer)):
        return np.int32
    return np.float32


def _is_int(v):
    return isinstance(v, (int, np.integer)) and not isinstance(
        v, (bool, np.bool_)
    )


def _wrap_i32(v):
    """int32 wraparound — field arithmetic IS int32 in the dense runtime,
    so the oracle models the same two's-complement semantics (matters when
    arithmetic touches the empty-reduce identity INT32_MAX/MIN)."""
    return int((int(v) + 2**31) % 2**32 - 2**31)


def _apply_binop(op, lhs, rhs):
    wrap = _is_int(lhs) and _is_int(rhs)
    if op == "+":
        return _wrap_i32(lhs + rhs) if wrap else lhs + rhs
    if op == "-":
        return _wrap_i32(lhs - rhs) if wrap else lhs - rhs
    if op == "*":
        return _wrap_i32(lhs * rhs) if wrap else lhs * rhs
    if op == "/":
        if rhs == 0:
            return math.inf if lhs > 0 else (-math.inf if lhs < 0 else math.nan)
        return lhs / rhs
    if op == "%":
        return lhs % rhs
    if op == "==":
        return lhs == rhs
    if op == "!=":
        return lhs != rhs
    if op == "<":
        return lhs < rhs
    if op == "<=":
        return lhs <= rhs
    if op == ">":
        return lhs > rhs
    if op == ">=":
        return lhs >= rhs
    if op == "&&":
        return bool(lhs) and bool(rhs)
    if op == "||":
        return bool(lhs) or bool(rhs)
    raise CompileError(f"unknown operator {op!r}")


def _apply_write(op, cur, val, dtype):
    wrap = np.issubdtype(dtype, np.integer) and _is_int(val)
    if op == ":=":
        out = val
    elif op == "+=":
        out = _wrap_i32(cur + val) if wrap else cur + val
    elif op == "*=":
        out = _wrap_i32(cur * val) if wrap else cur * val
    elif op == "<?=":
        out = min(cur, val)
    elif op == ">?=":
        out = max(cur, val)
    elif op == "||=":
        out = bool(cur) or bool(val)
    elif op == "&&=":
        out = bool(cur) and bool(val)
    else:
        raise CompileError(f"unknown write op {op!r}")
    if np.issubdtype(dtype, np.integer) and isinstance(out, float):
        if math.isinf(out):
            out = np.iinfo(dtype).max if out > 0 else np.iinfo(dtype).min
    if np.issubdtype(dtype, np.integer) and _is_int(out):
        out = _wrap_i32(out)
    return out


def _reduce(func, items, int_valued, sentinel=None):
    if func == "count":
        return len(items)
    if func == "argmin":
        if not items:
            return sentinel  # matches the dense executor's out-of-range id
        best = min(v for v, _ in items)
        return min(i for v, i in items if v == best)
    if func == "argmax":
        if not items:
            return sentinel
        best = max(v for v, _ in items)
        return min(i for v, i in items if v == best)
    if not items:
        ident = _IDENT[func]
        if func in _INT_IDENT and int_valued:
            return _INT_IDENT[func]
        return ident
    if func == "minimum":
        return min(items)
    if func == "maximum":
        return max(items)
    if func == "sum":
        return sum(items)
    if func == "prod":
        out = 1
        for v in items:
            out *= v
        return out
    if func == "and":
        return all(items)
    if func == "or":
        return any(items)
    raise CompileError(f"unknown reduce {func!r}")
