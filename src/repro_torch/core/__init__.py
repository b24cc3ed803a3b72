"""Palgol: the paper's contribution — DSL, logic solver, compiler, runtimes.

Public API (as ``repro.core``):
    parse(source)                        -> ast.Program
    compile_program(prog, graph, fields) -> CompiledProgram (eager, on the
                                            graph's device)
    interpret(prog, graph, fields)       -> reference oracle result (on
                                            the host, for a graph on any
                                            device)
    repro_torch.core.algorithms          -> stdlib of Palgol programs

``ast``, ``parser``, ``logic``, ``analysis``, ``plan``, ``stm``,
``algorithms`` and ``interpreter`` are the JAX package's framework-free
modules, copied with their imports rewritten; ``plan`` stays the only
source of superstep structure.
"""

import torch as _torch

from repro_torch.core.parser import parse
from repro_torch.core.compiler import compile_program
from repro_torch.core import interpreter as _interpreter
from repro_torch.core.plan import (
    ByteCostModel,
    ProgramPlan,
    StepPlan,
    fuse,
    lower_program,
    lower_step,
    plan_bytes,
)


def interpret(source_or_ast, graph, initial_fields=None, max_iters: int = 100_000):
    """The host oracle (:func:`repro_torch.core.interpreter.interpret`) on a
    graph and fields from any device: both are copied to the host first.
    Returns ``(fields dict of numpy arrays, trips list)``."""
    if initial_fields is not None:
        initial_fields = {
            k: v.cpu().numpy() if isinstance(v, _torch.Tensor) else v
            for k, v in initial_fields.items()
        }
    return _interpreter.interpret(
        source_or_ast, graph.to("cpu"), initial_fields, max_iters=max_iters
    )


__all__ = [
    "parse",
    "compile_program",
    "interpret",
    "ByteCostModel",
    "ProgramPlan",
    "StepPlan",
    "fuse",
    "lower_program",
    "lower_step",
    "plan_bytes",
]
