"""Dense code generation for Palgol steps, executed eagerly on torch tensors.

The port of ``repro.core.codegen`` (replicated placement). Every Palgol
step is a function ``(fields, graph) -> fields`` over struct-of-arrays
vertex state:

* all *reads* target the step's input fields (the paper's LC-phase rule:
  reads see the input graph);
* *local writes* read-modify-write an intermediate copy in program order;
* *remote writes* are collected during traversal and applied at the end via
  ``scatter_combine`` (the RU phase) — accumulative-only, so application
  order is irrelevant, exactly the paper's safety argument;
* chain accesses are evaluated through the :class:`~repro_torch.core.logic.PullSolver`
  gather DAG (memoized per step ⇒ each distinct sub-chain evaluated once);
* halted vertices (paper §3.4) are immutable: their local writes are masked
  and remote writes to/from them are dropped.

Remote reads go through ``graph.ops.gather`` and message combining through
``graph.ops.segment_reduce`` — on the card, the hand-written kernels. Each
edge context carries its ordering's segment offsets, so a reduction never
recomputes them.

Values follow JAX's typing with x64 off: a Python scalar from the source
text is *weak* (it takes the other operand's type within its kind), a
tensor is *strong*, and the result of a binary op is bool, int32 or
float32 by the kind of its widest operand (:func:`_result_dtype`). Torch's
own promotion differs (bool + int is int64 there), so every operator goes
through that rule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import ast
from repro_torch.core.analysis import CompileError, chain_pattern_of
from repro_torch.core.logic import PullSolver
from repro_torch.core.plan import (
    HALTED,
    IterInit,
    MainCompute,
    OpRef,
    ReadRound,
    RemoteUpdate,
    StepPlan,
    StopOp,
    lower_step,
)
from repro_torch.graph import ops as gops

# ---------------------------------------------------------------------------
# JAX (x64 off) typing of expression values: Python scalars are weak,
# tensors strong; kinds are bool < int < float.

_KIND_DTYPE = (torch.bool, torch.int32, torch.float32)


def _kind(x) -> int:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bool:
            return 0
        return 2 if x.dtype.is_floating_point else 1
    if isinstance(x, bool):
        return 0
    return 1 if isinstance(x, int) else 2


def _result_dtype(*xs) -> torch.dtype:
    """JAX's result dtype of an op over ``xs``: the widest kind wins; within
    it strong tensor dtypes promote, and weak scalars alone give the kind's
    default (bool, int32, float32)."""
    kind = max(_kind(x) for x in xs)
    strong = [
        x.dtype for x in xs if isinstance(x, torch.Tensor) and _kind(x) == kind
    ]
    if strong:
        return functools.reduce(torch.promote_types, strong)
    return _KIND_DTYPE[kind]


def _cast(x, dtype: torch.dtype):
    """``x`` as ``dtype``: a tensor converts (XLA's float→int rules), a
    Python scalar becomes the Python type of that kind."""
    if isinstance(x, torch.Tensor):
        if x.dtype == dtype:
            return x
        if dtype == torch.int32:
            return gops.to_int32(x)
        return x.to(dtype)
    if dtype == torch.bool:
        return bool(x)
    return float(x) if dtype.is_floating_point else int(x)


def _is_weak(*xs) -> bool:
    return not any(isinstance(x, torch.Tensor) for x in xs)


def _apply(fn, dtype, *xs):
    """``fn`` over ``xs`` cast to ``dtype``. All-scalar operands compute in
    ``dtype`` on 0-d CPU tensors and stay weak Python scalars, as a weakly
    typed JAX value is computed in its default dtype."""
    args = [_cast(x, dtype) for x in xs]
    if _is_weak(*xs):
        return fn(*(torch.tensor(a, dtype=dtype) for a in args)).item()
    if not isinstance(args[0], torch.Tensor):  # torch ops want a tensor first
        args[0] = torch.tensor(args[0], dtype=dtype)
    return fn(*args)


def _arith(fn, a, b):
    return _apply(fn, _result_dtype(a, b), a, b)


def _truediv(a, b):
    dtype = _result_dtype(a, b)
    if not dtype.is_floating_point:
        dtype = torch.float32
    return _apply(torch.true_divide, dtype, a, b)


def _logical(fn, a, b):
    """``jnp.logical_and``/``logical_or``: bool result; a scalar operand
    folds in on the host."""
    if _is_weak(a, b):
        return bool(fn(torch.tensor(bool(a)), torch.tensor(bool(b))))
    if _is_weak(a):
        a, b = b, a
    a = _as_mask(a)
    if not _is_weak(b):
        return fn(a, _as_mask(b))
    absorbing = fn is torch.logical_or  # x or True == True, x and False == False
    if bool(b) == absorbing:
        return torch.full_like(a, absorbing)
    return a


def _where(c, t, f):
    """``jnp.where(c, t, f)``: a nonzero ``c`` selects ``t``; ``t``/``f``
    promote together (weak if both are scalars)."""
    dtype = _result_dtype(t, f)
    if _is_weak(c):
        sel, other = (t, f) if c else (f, t)
        if _is_weak(sel, other) or isinstance(sel, torch.Tensor):
            return _cast(sel, dtype)
        return torch.full_like(other, sel, dtype=dtype)
    c = _as_mask(c)
    out = torch.where(c, _on(_cast(t, dtype), c), _on(_cast(f, dtype), c))
    return out if out.dtype == dtype else out.to(dtype)


def _on(x, like: torch.Tensor):
    """A 0-d tensor on another device than ``like`` as a Python scalar."""
    if isinstance(x, torch.Tensor) and x.ndim == 0 and x.device != like.device:
        return x.item()
    return x


def _as_mask(m: torch.Tensor) -> torch.Tensor:
    """A condition as a bool mask (``jnp.where`` reads nonzero as true)."""
    return m if m.dtype == torch.bool else m != 0


def _index(idx) -> torch.Tensor:
    """``jnp.asarray(idx, jnp.int32)`` as an int32 tensor."""
    if isinstance(idx, torch.Tensor):
        return _cast(idx, torch.int32)
    return torch.tensor(_cast(idx, torch.int32), dtype=torch.int32)


def _full(x, shape, device) -> torch.Tensor:
    """``jnp.broadcast_to(jnp.asarray(x), shape)`` as a dense tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        if x.ndim == 0:
            if x.device != torch.device(device):
                return torch.full(shape, x.item(), dtype=x.dtype, device=device)
            return x.expand(shape).contiguous()
        return x
    return torch.full(shape, x, dtype=_KIND_DTYPE[_kind(x)], device=device)


_OP_APPLY = {
    ":=": lambda cur, val: val,
    "+=": lambda cur, val: _arith(torch.add, cur, val),
    "*=": lambda cur, val: _arith(torch.mul, cur, val),
    "<?=": lambda cur, val: _arith(torch.minimum, cur, val),
    ">?=": lambda cur, val: _arith(torch.maximum, cur, val),
    "||=": lambda cur, val: _logical(torch.logical_or, cur, val),
    "&&=": lambda cur, val: _logical(torch.logical_and, cur, val),
}

_REDUCE_TO_COMBINER = {
    "minimum": "min",
    "maximum": "max",
    "sum": "sum",
    "prod": "prod",
    "and": "and",
    "or": "or",
}


@dataclasses.dataclass
class _EdgeCtx:
    direction: str
    nbr: torch.Tensor  # i32[E] neighbor ids (e.id)
    vid: torch.Tensor  # i32[E] current-vertex id per edge
    w: torch.Tensor  # f32[E] e.w
    emask: torch.Tensor  # bool[E]
    offsets: torch.Tensor  # i32[n+1] segment offsets of ``vid``


@dataclasses.dataclass
class _RemoteMsg:
    field: str
    op: str
    idx: torch.Tensor
    values: torch.Tensor
    mask: torch.Tensor  # same shape as idx


@dataclasses.dataclass
class _StepState:
    """One step's cross-superstep context under the fused program plan:
    what the step's remote-reading supersteps materialized and its main
    superstep emitted, threaded between the supersteps its plan ops landed
    in (the typed view of the executors' string-keyed mailbox)."""

    chain: Dict[tuple, torch.Tensor] = dataclasses.field(default_factory=dict)
    nbr: Dict[tuple, torch.Tensor] = dataclasses.field(default_factory=dict)
    pending: List[_RemoteMsg] = dataclasses.field(default_factory=list)
    naive_req: Dict[tuple, torch.Tensor] = dataclasses.field(default_factory=dict)


class StepExecutor:
    """Executes one Palgol step densely by running its :class:`StepPlan`
    op list eagerly. Instantiated fresh per call so the expression
    memo-cache is scoped to the step (paper's CSE guarantee).

    ``plan`` (or ``schedule``, which lowers one) selects the superstep
    expansion — the same :func:`repro_torch.core.plan.lower_step` plan the
    staged runtime consumes. Only the replicated placement is ported
    (``comm=None``): fields are ``[N]`` tensors on the graph's device.
    """

    def __init__(
        self,
        step: ast.Step,
        graph,
        comm=None,
        plan: Optional[StepPlan] = None,
        schedule: Optional[str] = None,
    ):
        if comm is not None:
            raise NotImplementedError(
                "the partitioned placement (comm=...) is not ported yet"
            )
        self.step = step
        self.graph = graph
        self.n = graph.n_vertices
        self.nrows = graph.n_vertices
        self.device = graph.device
        if plan is None:
            plan = lower_step(step, schedule=schedule or "pull")
        self.plan = plan
        self.info = plan.info
        self.pull = PullSolver()

    # -- public -------------------------------------------------------------
    def __call__(
        self,
        fields: Dict[str, torch.Tensor],
        chain_values: Optional[Dict[tuple, torch.Tensor]] = None,
        split_remote: bool = False,
        nbr_values: Optional[Dict[tuple, torch.Tensor]] = None,
    ):
        """Execute the plan's ops in order.

        ``chain_values`` seeds the chain cache with buffers materialized by
        earlier remote-reading supersteps (BSP mode) — seeded ReadRound
        work is skipped; ``nbr_values`` seeds per-edge neighborhood buffers
        keyed by ``(direction, pattern)``. With ``split_remote=True``
        returns ``(fields, pending_messages)`` so a separate
        remote-updating superstep can apply them (paper Fig. 9).
        """
        self.old = dict(fields)
        self.new = dict(fields)
        self.env: Dict[str, Tuple[str, torch.Tensor]] = {}
        self.chain_cache: Dict[tuple, torch.Tensor] = dict(chain_values or {})
        self.nbr_cache: Dict[tuple, torch.Tensor] = dict(nbr_values or {})
        self.expr_cache: Dict[Tuple[int, ast.Expr], object] = {}
        self.pending: List[_RemoteMsg] = []
        self._naive_req: Dict[tuple, torch.Tensor] = {}
        self.active = self._active_mask(fields)
        for op in self.plan.ops:
            if isinstance(op, ReadRound):
                self._exec_read_round(op)
            elif isinstance(op, MainCompute):
                self._exec_stmts(self.step.body, mask=None, ectx=None)
            elif not split_remote:  # RemoteUpdate
                self._apply_remote()
        if split_remote:
            return self.new, self.pending
        return self.new

    def apply_remote(self, fields, pending: List[_RemoteMsg]):
        """RU phase as a standalone superstep (BSP mode)."""
        self.old = dict(fields)
        self.new = dict(fields)
        self.pending = pending
        self.active = self._active_mask(fields)
        self._apply_remote()
        return self.new

    def run_ops(self, fields, ops, state: Optional["_StepState"] = None):
        """Execute a slice of this step's plan ops — the per-superstep entry
        point of the fused program plan, where one fused superstep may hold
        ops from several steps and a step's ops may land in different
        supersteps. ``state`` threads the step's cross-superstep context
        between slices; results equal one ``__call__`` over the whole plan.
        """
        state = state if state is not None else _StepState()
        self.old = dict(fields)
        self.new = dict(fields)
        self.env = {}
        self.chain_cache = dict(state.chain)
        self.nbr_cache = dict(state.nbr)
        self.expr_cache = {}
        self.pending = list(state.pending)
        self._naive_req = dict(state.naive_req)
        self.active = self._active_mask(fields)
        for op in ops:
            if isinstance(op, ReadRound):
                self._exec_read_round(op)
            elif isinstance(op, MainCompute):
                self._exec_stmts(self.step.body, mask=None, ectx=None)
            else:  # RemoteUpdate
                self._apply_remote()
                self.pending = []
        out_state = _StepState(
            # axioms (vertex ids / single-field reads) must not outlive the
            # superstep — a carried copy would go stale once the field is
            # written; only materialized multi-hop buffers are the mailbox
            chain={p: v for p, v in self.chain_cache.items() if len(p) > 1},
            nbr=dict(self.nbr_cache),
            pending=list(self.pending),
            naive_req=dict(self._naive_req),
        )
        return self.new, out_state

    # -- helpers ------------------------------------------------------------
    def _active_mask(self, fields) -> torch.Tensor:
        halted = fields.get(HALTED)
        if halted is None:
            halted = torch.zeros((self.nrows,), dtype=torch.bool, device=self.device)
        return ~halted

    def _ids(self) -> torch.Tensor:
        return torch.arange(self.n, dtype=torch.int32, device=self.device)

    def _read_nbr(self, per_row: torch.Tensor, ectx: _EdgeCtx) -> torch.Tensor:
        """Read a per-row array at each edge's neighbor."""
        return gops.gather(per_row, ectx.nbr)

    def _edge_ctx(self, direction: str) -> _EdgeCtx:
        nbr, vid, w, m = self.graph.edges(direction)
        return _EdgeCtx(direction, nbr, vid, w, m, self.graph.offsets(direction))

    def _segment(self, values, ectx: _EdgeCtx, op: str, mask=None):
        """Reduce per-edge values into their vertex's row."""
        return gops.segment_reduce(
            values, ectx.vid, self.nrows, op, indices_are_sorted=True,
            mask=mask, offsets=ectx.offsets,
        )

    def _field(self, name: str) -> torch.Tensor:
        if name == "Id":
            return self._ids()
        if name not in self.old:
            raise CompileError(f"read of undefined field {name!r}")
        return self.old[name]

    def _chain_value(self, pattern: tuple) -> torch.Tensor:
        """Evaluate a chain pattern at every vertex. The plan's ReadRound
        ops materialize every multi-hop pattern before the main compute, so
        during statement execution this resolves axioms (vertex ids, single
        fields) and cache hits; the pull-DAG fallback covers synthetic
        steps that run without plan rounds (stop conditions)."""
        if pattern in self.chain_cache:
            return self.chain_cache[pattern]
        if len(pattern) == 0:
            val = self._ids()
        elif len(pattern) == 1:
            val = self._field(pattern[0])
        else:
            plan = self.pull.solve(pattern)
            pre = self._chain_value(plan.prefix.pattern)
            suf = self._chain_value(plan.suffix.pattern)
            val = gops.gather(suf, pre)
        self.chain_cache[pattern] = val
        return val

    # -- plan-op execution ---------------------------------------------------
    def _exec_read_round(self, op: ReadRound):
        """Run one remote-reading superstep. Work whose result is already
        cached (seeded by a staged mailbox) is skipped — the op then only
        accounts for its superstep."""
        if op.kind == "request":
            # naive hop, requester→owner address push: the scatter the
            # manual code's wire traffic stands for
            for ce in op.chains:
                if ce.pattern in self.chain_cache:
                    continue
                cur = self._chain_value(ce.prefix)
                req = torch.full(
                    (self.n + 1,), self.n, dtype=torch.int32, device=self.device
                )
                self._naive_req[ce.pattern] = gops.scatter_set(
                    req, cur, self._ids()
                )[: self.n]
            return
        if op.kind == "push_request":
            # push address-propagation round: accounts for its superstep;
            # the push_reply round's gather does the work
            return
        # kind "pull", "reply" or "push_reply": gather suffix@prefix
        for ce in op.chains:
            if ce.pattern in self.chain_cache:
                continue
            pre = self._chain_value(ce.prefix)
            suf = self._chain_value(ce.suffix)
            val = gops.gather(suf, pre)
            req = self._naive_req.pop(ce.pattern, None)
            if req is not None:
                # fold in the request buffer: req < n+2 always, so this
                # term is exactly zero (kept so the scatter is not dead)
                val = _arith(
                    torch.add, val,
                    _cast(torch.floor_divide(req, self.n + 2), val.dtype),
                )
            self.chain_cache[ce.pattern] = val
        for direction, npat in op.nbr_sends:
            if (direction, npat) in self.nbr_cache:
                continue
            per_vertex = self._chain_value(npat)
            ectx = self._edge_ctx(direction)
            self.nbr_cache[(direction, npat)] = self._read_nbr(per_vertex, ectx)

    # -- expression evaluation ----------------------------------------------
    def _eval(self, e: ast.Expr, ectx: Optional[_EdgeCtx]):
        key = (id(ectx), e)
        if key in self.expr_cache:
            return self.expr_cache[key]
        val = self._eval_inner(e, ectx)
        self.expr_cache[key] = val
        return val

    def _eval_inner(self, e: ast.Expr, ectx: Optional[_EdgeCtx]):
        if isinstance(e, ast.Const):
            if e.value == "inf":
                return float("inf")
            return e.value
        if isinstance(e, ast.Var):
            if e.name == "numV":  # builtin: vertex count, a strong int32
                return torch.tensor(self.n, dtype=torch.int32)
            if e.name == self.step.vertex_var:
                return ectx.vid if ectx is not None else self._ids()
            if e.name in self.env:
                ctx_tag, arr = self.env[e.name]
                if ctx_tag == "vertex" and ectx is not None:
                    return gops.gather(arr, ectx.vid)
                return arr
            raise CompileError(f"unbound variable {e.name!r}")
        if isinstance(e, ast.EdgeProp):
            if ectx is None:
                raise CompileError(f".{e.prop} outside edge context")
            return ectx.nbr if e.prop == "id" else ectx.w
        if isinstance(e, ast.FieldAccess):
            # chain access from current vertex
            pat = chain_pattern_of(e, self.step.vertex_var)
            if pat is not None:
                val = self._chain_value(pat)
                return gops.gather(val, ectx.vid) if ectx is not None else val
            # neighborhood chain from e.id
            if ectx is not None:
                npat = self._nbr_pattern(e)
                if npat is not None:
                    cached = self.nbr_cache.get((ectx.direction, npat))
                    if cached is not None:
                        return cached
                    per_vertex = self._chain_value(npat)
                    return self._read_nbr(per_vertex, ectx)
            # general read
            idx = self._eval(e.index, ectx)
            return gops.gather(self._field(e.field), _index(idx))
        if isinstance(e, ast.Cond):
            c = self._eval(e.cond, ectx)
            t = self._eval(e.then, ectx)
            f = self._eval(e.other, ectx)
            return _where(c, t, f)
        if isinstance(e, ast.BinOp):
            lhs = self._eval(e.left, ectx)
            rhs = self._eval(e.right, ectx)
            return _binop(e.op, lhs, rhs)
        if isinstance(e, ast.UnOp):
            x = self._eval(e.operand, ectx)
            if e.op == "!":
                return (not x) if _is_weak(x) else torch.logical_not(x)
            return -x
        if isinstance(e, ast.Reduce):
            return self._eval_reduce(e)
        raise CompileError(f"cannot evaluate {type(e).__name__}")

    def _nbr_pattern(self, e: ast.FieldAccess):
        # pattern starting from any edge var's `.id` — edge var name is the
        # enclosing loop's; analysis validated scoping, so accept any
        def rec(x):
            if isinstance(x, ast.EdgeProp) and x.prop == "id":
                return ()
            if isinstance(x, ast.FieldAccess):
                inner = rec(x.index)
                if inner is not None:
                    return inner + (x.field,)
            return None

        return rec(e)

    def _eval_reduce(self, e: ast.Reduce) -> torch.Tensor:
        ectx = self._edge_ctx(e.range.direction)
        mask = ectx.emask
        for f in e.filters:
            fv = self._eval(f, ectx)
            mask = _logical(torch.logical_and, mask, fv)
        if e.func == "count":
            ones = torch.ones_like(ectx.vid, dtype=torch.int32)
            return self._segment(ones, ectx, "sum", mask=mask)
        body = _full(self._eval(e.body, ectx), ectx.vid.shape, self.device)
        if e.func in ("argmin", "argmax"):
            comb = "min" if e.func == "argmin" else "max"
            best = self._segment(body, ectx, comb, mask=mask)
            attained = torch.logical_and(mask, body == gops.gather(best, ectx.vid))
            ids = torch.where(attained, ectx.nbr, self.n)
            out = self._segment(ids, ectx, "min")
            # empty segments reduce to int-max; clamp to the sentinel (numV)
            return torch.clamp(out, max=self.n)
        comb = _REDUCE_TO_COMBINER[e.func]
        return self._segment(body, ectx, comb, mask=mask)

    # -- statement execution -------------------------------------------------
    def _shape(self, ectx: Optional[_EdgeCtx]):
        return ectx.vid.shape if ectx is not None else (self.nrows,)

    def _exec_stmts(self, stmts, mask, ectx: Optional[_EdgeCtx]):
        for s in stmts:
            if isinstance(s, ast.Let):
                val = _full(self._eval(s.value, ectx), self._shape(ectx), self.device)
                tag = "edge" if ectx is not None else "vertex"
                self.env[s.var] = (tag, val)
            elif isinstance(s, ast.If):
                c = _full(self._eval(s.cond, ectx), self._shape(ectx), self.device)
                m_then = c if mask is None else torch.logical_and(mask, c)
                self._exec_stmts(s.then, m_then, ectx)
                if s.other:
                    m_else = ~c if mask is None else torch.logical_and(mask, ~c)
                    self._exec_stmts(s.other, m_else, ectx)
            elif isinstance(s, ast.ForEdges):
                ec = self._edge_ctx(s.range.direction)
                m = ec.emask
                if mask is not None:  # lift vertex mask to edges
                    m = torch.logical_and(m, gops.gather(mask, ec.vid, fill=False))
                self._exec_stmts(s.body, m, ec)
            elif isinstance(s, ast.LocalWrite):
                self._local_write(s, mask, ectx)
            elif isinstance(s, ast.RemoteWrite):
                self._remote_write(s, mask, ectx)
            else:
                raise CompileError(f"unknown statement {type(s).__name__}")

    def _local_write(self, s: ast.LocalWrite, mask, ectx: Optional[_EdgeCtx]):
        val = _full(self._eval(s.value, ectx), self._shape(ectx), self.device)
        if ectx is None:
            cur = self.new.get(s.field)
            if cur is None:
                if s.op != ":=":
                    raise CompileError(
                        f"field {s.field!r} first written with accumulative op"
                    )
                cur = torch.zeros((self.nrows,), dtype=val.dtype, device=self.device)
            updated = _cast(_OP_APPLY[s.op](cur, val), cur.dtype)
            m = self.active if mask is None else torch.logical_and(mask, self.active)
            self.new[s.field] = torch.where(_as_mask(m), updated, cur)
        else:
            # accumulative write inside an edge loop: segment-reduce per-edge
            # contributions, then fold into the intermediate field once.
            if s.op == ":=":
                raise CompileError("`:=` inside an edge loop is order-dependent")
            comb = ast.OP_TO_COMBINER[s.op]
            m = ectx.emask if mask is None else mask
            cur = self.new.get(s.field)
            if cur is None:
                raise CompileError(
                    f"field {s.field!r} must exist before accumulation in a loop"
                )
            seg = self._segment(_cast(val, cur.dtype), ectx, comb, mask=_as_mask(m))
            updated = _cast(_OP_APPLY[s.op](cur, seg), cur.dtype)
            self.new[s.field] = torch.where(self.active, updated, cur)

    def _remote_write(self, s: ast.RemoteWrite, mask, ectx: Optional[_EdgeCtx]):
        shape = self._shape(ectx)
        idx = _full(_index(self._eval(s.target, ectx)), shape, self.device)
        val = _full(self._eval(s.value, ectx), shape, self.device)
        # sender must be active
        sender_active = (
            gops.gather(self.active, ectx.vid, fill=False)
            if ectx is not None
            else self.active
        )
        m = sender_active if mask is None else torch.logical_and(mask, sender_active)
        if ectx is not None:
            m = torch.logical_and(m, ectx.emask)
        self.pending.append(_RemoteMsg(s.field, s.op, idx, val, m))

    def _apply_remote(self):
        for msg in self.pending:
            if msg.field not in self.new:
                raise CompileError(
                    f"remote write to undefined field {msg.field!r}"
                )
            buf = self.new[msg.field]
            comb = ast.OP_TO_COMBINER[msg.op]
            # receiver must be active
            recv_active = gops.gather(self.active, msg.idx, fill=False)
            m = torch.logical_and(msg.mask, recv_active)
            self.new[msg.field] = gops.scatter_combine(
                buf, msg.idx, _cast(msg.values, buf.dtype), comb, mask=m
            )


def _binop(op: str, lhs, rhs):
    if op == "+":
        return _arith(torch.add, lhs, rhs)
    if op == "-":
        return _arith(torch.sub, lhs, rhs)
    if op == "*":
        return _arith(torch.mul, lhs, rhs)
    if op == "/":
        # Palgol `/` is numeric division (PageRank): true division, ints
        # giving float32
        return _truediv(lhs, rhs)
    if op == "%":
        return _arith(torch.remainder, lhs, rhs)  # floor-mod, as jnp
    if op == "==":
        return _arith(torch.eq, lhs, rhs)
    if op == "!=":
        return _arith(torch.ne, lhs, rhs)
    if op == "<":
        return _arith(torch.lt, lhs, rhs)
    if op == "<=":
        return _arith(torch.le, lhs, rhs)
    if op == ">":
        return _arith(torch.gt, lhs, rhs)
    if op == ">=":
        return _arith(torch.ge, lhs, rhs)
    if op == "&&":
        return _logical(torch.logical_and, lhs, rhs)
    if op == "||":
        return _logical(torch.logical_or, lhs, rhs)
    raise CompileError(f"unknown operator {op!r}")


# ---------------------------------------------------------------------------
# fused-program-plan execution: one Superstep part at a time
#
# The program-level mailbox is a flat string-keyed dict. Keys are
# namespaced by step ordinal (``s<i>:``) so two steps materializing the
# same chain pattern cannot collide:
#
#   s<i>:chain:<f1>/<f2>...   materialized chain buffer (pattern-keyed)
#   s<i>:nbr:<dir>:<f1>...    per-edge neighborhood buffer
#   s<i>:req:<f1>/...         naive request buffer
#   s<i>:pending              remote-write payload (Main -> RemoteUpdate),
#                             a tuple of (idx, values, mask) triples in
#                             RemoteUpdate.writes order


def _pat_key(pattern: tuple) -> str:
    return "/".join(pattern)


def _ns_import(ns: str, mailbox, ru_writes) -> "_StepState":
    """Decode one step's mailbox entries into its typed _StepState."""
    state = _StepState()
    for k, v in mailbox.items():
        if not k.startswith(ns):
            continue
        rest = k[len(ns):]
        if rest.startswith("chain:"):
            state.chain[tuple(rest[len("chain:"):].split("/"))] = v
        elif rest.startswith("nbr:"):
            _, direction, pat = rest.split(":", 2)
            state.nbr[(direction, tuple(pat.split("/")) if pat else ())] = v
        elif rest.startswith("req:"):
            state.naive_req[tuple(rest[len("req:"):].split("/"))] = v
        elif rest == "pending":
            state.pending = [
                _RemoteMsg(f, op, idx, val, mask)
                for (f, op), (idx, val, mask) in zip(ru_writes, v)
            ]
    return state


def _ns_export(ns: str, mailbox, op, state: "_StepState"):
    """Re-encode a step's post-op state into the mailbox. MainCompute
    consumes the step's read buffers, RemoteUpdate consumes its pending
    payload — after a step's last op only prefetched entries remain."""
    out = {k: v for k, v in mailbox.items() if not k.startswith(ns)}
    pending = tuple((m.idx, m.values, m.mask) for m in state.pending)
    if isinstance(op, ReadRound):
        for p, v in state.chain.items():
            out[f"{ns}chain:{_pat_key(p)}"] = v
        for (d, p), v in state.nbr.items():
            out[f"{ns}nbr:{d}:{_pat_key(p)}"] = v
        for p, v in state.naive_req.items():
            out[f"{ns}req:{_pat_key(p)}"] = v
        if pending:
            out[f"{ns}pending"] = pending
    elif isinstance(op, MainCompute):
        if pending:
            out[f"{ns}pending"] = pending
    # RemoteUpdate: everything consumed
    return out


def exec_plan_part(ref: OpRef, graph, comm, fields, mailbox):
    """Execute one part of a fused :class:`~repro_torch.core.plan.Superstep`
    — the per-op consumer of the program plan that the whole-program path
    (``CompiledProgram.fn``) walks. Returns ``(fields, mailbox)``."""
    op = ref.op
    if isinstance(op, IterInit):
        return fields, mailbox
    if isinstance(op, StopOp):
        return make_stop_fn(op.stop, graph, comm=comm)(fields), mailbox
    ns = f"s{ref.sidx}:"
    plan = ref.plan
    ru = next((o for o in plan.ops if isinstance(o, RemoteUpdate)), None)
    state = _ns_import(ns, mailbox, ru.writes if ru is not None else ())
    ex = StepExecutor(plan.step, graph, comm=comm, plan=plan)
    fields, state = ex.run_ops(fields, [op], state)
    return fields, _ns_export(ns, mailbox, op, state)


def make_stop_fn(stop: ast.StopStep, graph, comm=None):
    """StopStep → fields update flipping the halted mask (paper §3.4)."""

    def stop_fn(fields):
        # reuse StepExecutor's evaluator on a synthetic empty step
        ex = StepExecutor(ast.Step(stop.vertex_var, ()), graph, comm=comm)
        ex.old = dict(fields)
        ex.new = dict(fields)
        ex.env = {}
        ex.chain_cache = {}
        ex.nbr_cache = {}
        ex.expr_cache = {}
        ex.pending = []
        ex.active = ex._active_mask(fields)
        cond = _full(ex._eval(stop.cond, None), (ex.nrows,), ex.device)
        halted = fields.get(HALTED)
        if halted is None:
            halted = torch.zeros((ex.nrows,), dtype=torch.bool, device=ex.device)
        out = dict(fields)
        out[HALTED] = torch.logical_or(halted, cond)
        return out

    return stop_fn
