"""The chain-access logic system (paper §4.1.1) + a TPU-native pull variant.

Patterns
--------
A *chain access pattern* is a tuple of field names applied left-to-right to
the current vertex ``u``: ``()`` is ``u`` itself, ``("D",)`` is ``D[u]``,
``("D", "D")`` is ``D[D[u]]`` (= D²[u]), ``("B", "A")`` is ``A[B[u]]``.
``a ≼ b`` ("a is a subpattern of b") iff ``a`` is a proper prefix of ``b``.

Push mode (paper-faithful)
--------------------------
Propositions ``∀u. K_{v(u)} e(u)`` are pairs ``(v, e)`` of patterns. Axioms:

    1. step(K_u u)      = 0
    2. step(K_u F[u])   = 0                       (for any field F)
    3. K_{w} e ∧ K_{w} v ⇒ K_{v} e                (message passing)

and the recursive cost is

    step(K_v e) = 1 + min_{w ∈ Sub(e,v)} max(step(gen(K_w e)), step(gen(K_w v)))

with ``Sub(a,b)`` = proper prefixes of ``a`` and of ``b``, and ``gen``
(generalize) rewriting ``K_{a} b → K_u (b/a)`` whenever ``a ≼ b``. Memoized;
minimizes the number of *communication rounds* (supersteps), reproducing the
paper's ``D⁴[u]`` in 3 rounds instead of 6 request/reply rounds.

Pull mode (beyond-paper, TPU-native)
------------------------------------
On a shared-address-space machine (sharded arrays + XLA gather collectives) a
remote read is one-sided: no request round and no address propagation are
needed.  If ``X[u] = p(u)`` and ``Y[u] = q(u)`` are knowledge arrays then
``Y[X] = (q∘p)(u)`` costs **one** gather round, so

    rounds(p) = 1 + min over splits p = s ++ t of max(rounds(s), rounds(t))

with rounds(()) = rounds((F,)) = 0 — i.e. pointer doubling: ``D⁴`` in 2
rounds, any depth-k chain in ⌈log₂ k⌉ rounds for uniform chains. Both solvers
share a memo table per compilation so repeated sub-chains are evaluated once
(the paper's "evaluated exactly once even if it appears multiple times").
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

Pattern = Tuple[str, ...]  # field names applied left-to-right from u

INF = 10**9


def is_subpattern(a: Pattern, b: Pattern) -> bool:
    """a ≼ b: b is a consecutive field access starting from a (a proper prefix)."""
    return len(a) < len(b) and b[: len(a)] == a


def proper_prefixes(p: Pattern) -> List[Pattern]:
    return [p[:k] for k in range(len(p))]


def generalize(target: Pattern, expr: Pattern) -> Tuple[Pattern, Pattern]:
    """gen(K_{a} b) = K_u (b/a) when a ≼ b (paper's `generalize`)."""
    if is_subpattern(target, expr) or target == expr[: len(target)]:
        # target is a (possibly improper) prefix of expr
        if expr[: len(target)] == target:
            return ((), expr[len(target):])
    return (target, expr)


# ---------------------------------------------------------------------------
# push mode (paper §4.1.1)


@dataclasses.dataclass(frozen=True)
class PushPlan:
    """Derivation tree of the message-passing axiom.

    ``rounds == 0`` means an axiom (local knowledge). Otherwise the final
    round sends ``expr`` from intermediate ``via`` to ``target``, after the
    two sub-plans complete (they run in parallel: max, not sum).
    """

    target: Pattern
    expr: Pattern
    rounds: int
    via: Optional[Pattern] = None
    value_plan: Optional["PushPlan"] = None
    addr_plan: Optional["PushPlan"] = None


class PushSolver:
    """Memoized DP over propositions (K_v e). One instance per compilation,
    so shared sub-chains across a Palgol step are planned exactly once."""

    def __init__(self):
        self.memo: Dict[Tuple[Pattern, Pattern], PushPlan] = {}
        self._in_progress: set = set()

    def solve(self, target: Pattern, expr: Pattern) -> PushPlan:
        target, expr = generalize(target, expr)
        key = (target, expr)
        if key in self.memo:
            return self.memo[key]
        # axioms
        if target == () and len(expr) <= 1:
            plan = PushPlan(target, expr, 0)
            self.memo[key] = plan
            return plan
        if key in self._in_progress:  # cycle guard (can't happen with Sub, but safe)
            return PushPlan(target, expr, INF)
        self._in_progress.add(key)

        best: Optional[PushPlan] = None
        candidates = set(proper_prefixes(expr)) | set(proper_prefixes(target))
        for w in sorted(candidates, key=len):
            vp = self.solve(w, expr)
            ap = self.solve(w, target)
            rounds = 1 + max(vp.rounds, ap.rounds)
            if best is None or rounds < best.rounds:
                best = PushPlan(target, expr, rounds, via=w, value_plan=vp,
                                addr_plan=ap)
        self._in_progress.discard(key)
        assert best is not None, (target, expr)
        self.memo[key] = best
        return best

    def rounds(self, expr: Pattern) -> int:
        """Communication rounds for ∀u. K_u expr(u)."""
        return self.solve((), expr).rounds


# ---------------------------------------------------------------------------
# pull mode (TPU-native gather staging)


@dataclasses.dataclass(frozen=True)
class PullPlan:
    """Gather DAG node: pattern = suffix ∘ prefix, evaluated as
    ``take(eval(suffix), eval(prefix))``. rounds == 0 for () and single
    fields (local array reads)."""

    pattern: Pattern
    rounds: int
    prefix: Optional["PullPlan"] = None
    suffix: Optional["PullPlan"] = None


class PullSolver:
    """Minimum gather-depth evaluation of chain patterns with CSE.

    The memo table doubles as the common-subexpression cache: the codegen
    evaluates each distinct sub-pattern once per step (paper §4.1.1's
    memoization extension), and the DAG depth equals the number of dependent
    collective rounds under pjit.
    """

    def __init__(self):
        self.memo: Dict[Pattern, PullPlan] = {}

    def solve(self, pattern: Pattern) -> PullPlan:
        if pattern in self.memo:
            return self.memo[pattern]
        if len(pattern) <= 1:
            plan = PullPlan(pattern, 0)
            self.memo[pattern] = plan
            return plan
        best: Optional[PullPlan] = None
        for k in range(1, len(pattern)):
            pre = self.solve(pattern[:k])
            suf = self.solve(pattern[k:])
            rounds = 1 + max(pre.rounds, suf.rounds)
            if best is None or rounds < best.rounds:
                best = PullPlan(pattern, rounds, prefix=pre, suffix=suf)
        assert best is not None
        self.memo[pattern] = best
        return best

    def rounds(self, pattern: Pattern) -> int:
        return self.solve(pattern).rounds

    def schedule(self, patterns) -> List[Pattern]:
        """Topologically-ordered unique sub-patterns needed to evaluate
        ``patterns`` (every chain appears after its prefix/suffix)."""
        order: List[Pattern] = []
        seen = set()

        def visit(plan: PullPlan):
            if plan.pattern in seen:
                return
            if plan.prefix is not None:
                visit(plan.prefix)
                visit(plan.suffix)
            seen.add(plan.pattern)
            order.append(plan.pattern)

        for p in patterns:
            visit(self.solve(p))
        return order


@functools.lru_cache(maxsize=None)
def push_rounds(expr: Pattern) -> int:
    """Convenience: paper-faithful round count for ∀u. K_u expr."""
    return PushSolver().rounds(expr)


@functools.lru_cache(maxsize=None)
def pull_rounds(expr: Pattern) -> int:
    """Beyond-paper: gather-staged round count for the same read."""
    return PullSolver().rounds(expr)
