"""The port's copied frontend against the JAX package's — the drift guard.

``repro_torch.core`` keeps its own copies of the framework-free frontend
(``ast``, ``parser``, ``logic``, ``analysis``, ``plan``, ``stm``,
``algorithms``, ``interpreter``), because the card it runs on has no JAX and
importing ``repro.core`` imports the JAX compiler. These tests hold each
copy to its original: the same source apart from the package name, and for
every program × schedule × fuse the same superstep plan and the same STM
cost models. They also check that the port imports without JAX.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import parser as jparser  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import stm as jstm  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import parser as tparser  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import stm as tstm  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
COPIED = ("ast", "parser", "logic", "analysis", "plan", "stm", "algorithms", "interpreter")


@pytest.mark.parametrize("module", COPIED)
def test_copy_matches_original_source(module):
    """A copied module differs from the JAX package's only in its imports."""
    port = (SRC / "repro_torch" / "core" / f"{module}.py").read_text()
    orig = (SRC / "repro" / "core" / f"{module}.py").read_text()
    assert port.replace("repro_torch.", "repro.") == orig


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("schedule", ["pull", "push", "naive", "auto"])
@pytest.mark.parametrize("name", sorted(jalg.ALL))
def test_program_plan_matches(name, schedule, fuse):
    """Same superstep structure: the items (supersteps with their op parts,
    loops) render identically, and so do the per-step plans and costs."""
    jprog = jparser.parse(jalg.ALL[name])
    tprog = tparser.parse(talg.ALL[name])
    assert repr(tprog) == repr(jprog)
    jpp = jplan.lower_program(jprog, schedule=schedule)
    tpp = tplan.lower_program(tprog, schedule=schedule)
    if fuse:
        jpp, tpp = jplan.fuse(jpp), tplan.fuse(tpp)
    assert repr(tpp.items) == repr(jpp.items)
    assert tpp.describe() == jpp.describe()
    assert tpp.cost() == jpp.cost()
    assert [p.describe() for _, p in tpp.step_plans] == [
        p.describe() for _, p in jpp.step_plans
    ]


@pytest.mark.parametrize("name", sorted(jalg.ALL))
def test_superstep_report_matches(name):
    """Same STM cost models under every compilation regime."""
    jrep = jstm.superstep_report(jparser.parse(jalg.ALL[name]))
    trep = tstm.superstep_report(tparser.parse(talg.ALL[name]))
    assert {k: dataclasses.astuple(v) for k, v in trep.items()} == {
        k: dataclasses.astuple(v) for k, v in jrep.items()
    }


def test_port_imports_without_jax():
    """``repro_torch`` imports with ``jax`` and ``repro`` unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.graph, "
        "repro_torch.pregel, repro_torch.kernels\n"
        "from repro_torch.graph import generators\n"
        "from repro_torch.core import compile_program, algorithms\n"
        "g = generators.chain(8, device='cpu')\n"
        "compile_program(algorithms.SSSP, g).run()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
