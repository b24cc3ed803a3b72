"""``repro_torch.pregel.runtime._StagedStep.read_stage_fns`` against the JAX
package's, on the CPU.

For every program × schedule: one callable per ``ReadRound`` of the step's
plan, as many as ``read_superstep_count`` charges (the accounting mirror
that ``tests/test_partition.py::test_matches_staged_stage_count`` holds in
JAX), and, applied in order to JAX's ``init_fields()`` on a small R-MAT
from an empty mailbox, the same mailbox as JAX's callables: the same keys
and every value equal, exactly (NaN equal to NaN).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import ast as jast  # noqa: E402
from repro.core import compile_program as jax_compile  # noqa: E402
from repro.core.analysis import iter_steps as jiter_steps  # noqa: E402
from repro.graph import generators as JG  # noqa: E402
from repro.pregel.runtime import _StagedStep as JStaged  # noqa: E402
from repro.pregel.runtime import read_superstep_count as jcount  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import ast as tast  # noqa: E402
from repro_torch.core import compile_program as torch_compile  # noqa: E402
from repro_torch.core.analysis import iter_steps as titer_steps  # noqa: E402
from repro_torch.core.plan import lower_step  # noqa: E402
from repro_torch.graph import generators as TG  # noqa: E402
from repro_torch.graph.structure import fields_from_arrays  # noqa: E402
from repro_torch.pregel.runtime import _StagedStep as TStaged  # noqa: E402
from repro_torch.pregel.runtime import read_superstep_count as tcount  # noqa: E402

PROGRAMS = ["sssp", "sv", "wcc", "mis", "mwm", "chain4", "pagerank"]
SCHEDULES = ["pull", "push", "naive", "auto"]


def _setup(name, n_log2=6):
    """JAX's and the port's compiled program on the same R-MAT, and JAX's
    initial fields."""
    kw = dict(avg_degree=4.0, directed=name == "sssp", weighted=True, seed=2)
    jg, tg = JG.rmat(n_log2, **kw), TG.rmat(n_log2, device="cpu", **kw)
    n = jg.n_vertices
    rng = np.random.default_rng(5)
    fields = None
    if name == "chain4":
        fields = {"D": rng.integers(0, n, n).astype(np.int32)}
    elif name == "mis":
        fields = {"P": rng.random(n).astype(np.float32)}
    jcp = jax_compile(jalg.ALL[name], jg,
                      initial_fields=None if fields is None else
                      {k: jnp.asarray(v) for k, v in fields.items()})
    tcp = torch_compile(talg.ALL[name], tg, initial_fields=fields_from_arrays(fields, "cpu")
                        if fields is not None else None)
    init = {k: np.asarray(v) for k, v in jcp.init_fields(
        None if fields is None else {k: jnp.asarray(v) for k, v in fields.items()}).items()}
    return jg, tg, jcp, tcp, init


def _steps(jcp, tcp):
    js = [s for s in jiter_steps(jcp.prog) if isinstance(s, jast.Step)]
    ts = [s for s in titer_steps(tcp.prog) if isinstance(s, tast.Step)]
    assert len(js) == len(ts) > 0
    return list(zip(js, ts))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", PROGRAMS)
def test_stage_count_is_read_superstep_count(name, schedule):
    _, tg, jcp, tcp, _ = _setup(name)
    for _, step in _steps(jcp, tcp):
        staged = TStaged(lower_step(step, schedule=schedule), tg)
        assert len(staged.read_stage_fns()) == tcount(step, schedule), (name, schedule)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", PROGRAMS)
def test_stage_fns_give_jax_mailboxes(name, schedule):
    jg, tg, jcp, tcp, init = _setup(name)
    jfields = {k: jnp.asarray(v) for k, v in init.items()}
    tfields = fields_from_arrays(init, "cpu")
    for jstep, tstep in _steps(jcp, tcp):
        jfns = JStaged(jstep, jg, schedule).read_stage_fns()
        tfns = TStaged(lower_step(tstep, schedule=schedule), tg).read_stage_fns()
        assert len(tfns) == len(jfns) == jcount(jstep, schedule)
        jbox, tbox = {}, {}
        for jfn, tfn in zip(jfns, tfns):
            jbox = jfn(jfields, jbox)
            tbox = tfn(tfields, tbox)
            assert sorted(tbox) == sorted(jbox), (name, schedule)
            for key, want in jbox.items():
                want, got = np.asarray(want), tbox[key].cpu().numpy()
                assert got.dtype == want.dtype and got.shape == want.shape, key
                assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f"), key
