"""The port's main path against the JAX package, end to end on the CPU.

Every program of ``algorithms.ALL`` × schedule × fuse runs through the
port's ``run_bsp`` and ``compile_program(...).run()`` and through the JAX
package's, on the same small generator graph and the same seeded inputs
(numpy, handed to both). Required equal: every field exactly — except the
float sums of PageRank, within the f32 ``TOL`` of tests/test_kernels.py
(rtol = atol = 2e-5), because the port's segment sum adds in another order
than ``jax.ops.segment_sum`` — and the executed supersteps, trips and
fixed-point frontiers exactly. The plan-derived superstep targets of
BENCH_palgol_mesh.json must hold for the port as they do for JAX.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import compile_program as jax_compile  # noqa: E402
from repro.graph import generators as JG  # noqa: E402
from repro.pregel import run_bsp as jax_run_bsp  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import compile_program as torch_compile  # noqa: E402
from repro_torch.graph import generators as TG  # noqa: E402
from repro_torch.graph import structure as TS  # noqa: E402
from repro_torch.pregel import run_bsp as torch_run_bsp  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)  # f32 TOL of tests/test_kernels.py
SCHEDULES = ("pull", "push", "naive", "auto")
#: float fields computed by a float segment sum (order-dependent rounding)
FLOAT_SUM_FIELDS = {"pagerank": {"PR"}}
BENCH = Path(__file__).resolve().parent.parent / "BENCH_palgol_mesh.json"


def _case(name):
    """(JAX graph, initial fields as numpy) for one program, seeded."""
    rng = np.random.default_rng(6)
    fields = None
    if name in ("sssp", "bfs"):
        g = JG.erdos_renyi(96, 4.0, directed=True, weighted=True, seed=1)
    elif name == "pagerank":
        g = JG.rmat(7, avg_degree=6.0, directed=True, seed=2)
    elif name == "scc":
        g = JG.erdos_renyi(64, 2.0, directed=True, seed=3)
    elif name in ("sv", "label_prop"):
        g = JG.rmat(7, avg_degree=2.0, directed=False, seed=4)
    elif name == "wcc":
        g = JG.grid2d(8, 12)
    elif name == "mis":
        g = JG.erdos_renyi(128, 3.0, directed=False, seed=5)
        fields = {"P": rng.random(g.n_vertices).astype(np.float32)}
    elif name == "bipartite_matching":
        g, side = JG.random_bipartite(24, 20, 3.0, seed=6)
        fields = {"Side": side}
    elif name == "mwm":
        g = JG.erdos_renyi(96, 3.0, directed=False, weighted=True, seed=7)
    elif name == "kcore":
        g = JG.erdos_renyi(96, 5.0, directed=False, seed=8)
        fields = {"K": np.full(g.n_vertices, 4, np.int32)}
    elif name == "chain4":
        g = JG.erdos_renyi(64, 2.0, directed=False, seed=9)
        fields = {"D": rng.integers(0, 64, 64).astype(np.int32)}
    else:
        raise KeyError(name)
    return g, fields


def _port_graph(jg):
    leaves = {k: np.asarray(getattr(jg, k)) for k in TS.EDGE_ARRAYS}
    return TS.from_arrays(**leaves, n_vertices=jg.n_vertices, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_dense(name):
    """JAX ``cp.run()`` (fields, trips, counts), once per program."""
    g, fields = _case(name)
    jfields = None if fields is None else {k: jax.numpy.asarray(v) for k, v in fields.items()}
    cp = jax_compile(jalg.ALL[name], g, initial_fields=jfields)
    out, trips, counts = cp.run(jfields)
    return {k: np.asarray(v) for k, v in out.items()}, trips, counts, cp


@functools.lru_cache(maxsize=None)
def _jax_bsp(name, schedule, fuse):
    g, fields = _case(name)
    jfields = None if fields is None else {k: jax.numpy.asarray(v) for k, v in fields.items()}
    cp = _jax_dense(name)[3]
    res = jax_run_bsp(cp.prog, g, cp.init_fields(jfields), schedule=schedule, fuse=fuse)
    return (
        {k: np.asarray(v) for k, v in res.fields.items()},
        res.supersteps, res.trips, res.active_sets,
    )


def _assert_fields(name, want, got):
    assert set(want) == set(got), (name, sorted(want), sorted(got))
    for f, a in want.items():
        b = got[f].cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (name, f, a.dtype, b.dtype)
        if f in FLOAT_SUM_FIELDS.get(name, ()):
            np.testing.assert_allclose(b, a, **TOL, err_msg=f"{name}.{f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{f}")


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", sorted(talg.ALL))
def test_port_matches_jax(name, schedule, fuse):
    jg, fields = _case(name)
    tg = _port_graph(jg)
    fields = None if fields is None else TS.fields_from_arrays(fields, device="cpu")
    j_fields, j_steps, j_trips, j_active = _jax_bsp(name, schedule, fuse)
    j_dense, j_dense_trips, j_counts, _ = _jax_dense(name)

    cp = torch_compile(
        talg.ALL[name], tg, initial_fields=fields, schedule=schedule, fuse=fuse
    )
    res = torch_run_bsp(
        cp.prog, tg, cp.init_fields(fields), schedule=schedule, fuse=fuse
    )
    assert (res.supersteps, res.trips, res.active_sets) == (
        j_steps, j_trips, j_active
    ), name
    _assert_fields(name, j_fields, res.fields)

    out, trips, counts = cp.run(fields)
    assert trips == j_dense_trips, name
    assert {k: counts[k] for k in j_counts} == j_counts, name
    _assert_fields(name, j_dense, out)


@pytest.mark.parametrize("name", ["chain4", "sssp", "wcc"])
def test_exported_oracle_matches_jax(name):
    """``repro_torch.core.interpret`` takes a port graph and tensor fields
    and equals the JAX package's ``repro.core.interpret`` exactly."""
    from repro.core import interpret as jax_interpret
    from repro_torch.core import interpret as torch_interpret

    jg, fields = _case(name)
    want, want_trips = jax_interpret(jalg.ALL[name], jg, fields)
    tfields = None if fields is None else TS.fields_from_arrays(fields, device="cpu")
    got, got_trips = torch_interpret(talg.ALL[name], _port_graph(jg), tfields)
    assert got_trips == want_trips and set(got) == set(want)
    for f, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(a), err_msg=f)


def _bench_cells():
    per_algo = json.loads(BENCH.read_text())["schedules"]["per_algo"]
    return [
        (algo, sched, cell[sched]["fused_supersteps"], cell[sched]["executed_supersteps"])
        for algo, cell in sorted(per_algo.items())
        for sched in SCHEDULES
    ]


@pytest.mark.parametrize("algo,schedule,fused,unfused", _bench_cells())
def test_bench_superstep_targets(algo, schedule, fused, unfused):
    """The port executes the committed plan-derived superstep counts on the
    benchmark's own graph (SSSP 11/22, WCC 8/16, PageRank 31/62, S-V pull
    13/20, push 19/26, naive 25/32, chain4 3/4/7)."""
    g = TG.erdos_renyi(64, 4.0, directed=False, weighted=True, seed=0, device="cpu")
    fields = None
    if algo == "chain4":
        fields = {"D": np.random.default_rng(0).integers(0, 64, 64).astype(np.int32)}
    cp = torch_compile(talg.ALL[algo], g, initial_fields=fields)
    got = [
        torch_run_bsp(
            cp.prog, g, cp.init_fields(fields), schedule=schedule, fuse=fz
        ).supersteps
        for fz in (True, False)
    ]
    assert got == [fused, unfused], (algo, schedule)
