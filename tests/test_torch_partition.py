"""The port's partitioned placement against the JAX package, on the CPU.

``repro_torch.graph.partition`` is held to ``repro.graph.partition`` on the
same inputs (the JAX package's generator graphs and initial fields, handed
over as numpy):

* the partitioner's arrays and the communication statistics equal JAX's,
  and reproduce ``BENCH_palgol_mesh.json``'s partition and request-dedup
  figures;
* one shard in process: every program of the JAX suite's
  ``TestPartitionedExecutionSingleShard`` × pull/push/naive × fuse gives
  JAX's ``run_bsp(placement="partitioned", n_shards=1)`` fields (exact;
  f32 sums within ``TOL``), supersteps, trips and frontiers;
* eight gloo ranks on the CPU (``tests/torch_partition_ranks.py``, the
  counterpart of ``test_partitioned_multidevice_equivalence``): the
  programs equal JAX's, and ``halo_exchange``, ``gather_global`` and
  ``scatter_reduce`` equal the dense ``graph.ops`` result on every shard;
* the refusals mirror JAX's.
"""

import json
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import compile_program as jax_compile  # noqa: E402
from repro.graph import generators as JG  # noqa: E402
from repro.graph import partition as JP  # noqa: E402
from repro.pregel import run_bsp as jax_run_bsp  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import compile_program as torch_compile  # noqa: E402
from repro_torch.core import parse as torch_parse  # noqa: E402
from repro_torch.dist import shard_mesh  # noqa: E402
from repro_torch.graph import generators as TG  # noqa: E402
from repro_torch.graph import partition as TP  # noqa: E402
from repro_torch.graph import structure as TS  # noqa: E402
from repro_torch.pregel import run_bsp as torch_run_bsp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)  # f32 TOL of tests/test_kernels.py
BENCH = json.loads((ROOT / "BENCH_palgol_mesh.json").read_text())

#: bool ||= / &&= remote writes at computed and edge targets: the or/and
#: branch of scatter_reduce (tests/test_partition.py's program)
BOOL_COMBINER_PROG = textwrap.dedent(
    """
    for v in V
        local Flag[v] := (Id[v] % 7 == 0)
        local Tgt[v] := (Id[v] * 13) % numV
        local All[v] := true
    end
    for v in V
        if (Flag[v])
            remote Flag[Tgt[v]] ||= true
            for (e <- Nbr[v])
                remote Flag[e.id] ||= true
        for (e <- Nbr[v])
            remote All[e.id] &&= (Id[v] % 2 == 0)
    end
    """
)
PROGRAMS = dict(jalg.ALL, bool_comb=BOOL_COMBINER_PROG)


def _port_graph(jg):
    leaves = {k: np.asarray(getattr(jg, k)) for k in TS.EDGE_ARRAYS}
    return TS.from_arrays(**leaves, n_vertices=jg.n_vertices, device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the partitioner and the statistics ---------------------------------------

GRAPHS = {
    "erdos_renyi": lambda: JG.erdos_renyi(60, 5.0, directed=True, weighted=True, seed=2),
    "grid2d": lambda: JG.grid2d(16, 8),
    "rmat": lambda: JG.rmat(8, avg_degree=6.0, directed=True, seed=7),
}
PG_ARRAYS = (
    "starts", "vmask", "src_g", "src_h", "dst_l", "w", "emask",
    "t_dst_g", "t_dst_h", "t_src_l", "t_w", "t_emask",
)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_graph_matches_jax(graph, n_shards):
    jg = GRAPHS[graph]()
    jpg = JP.partition_graph(jg, n_shards)
    tpg = TP.partition_graph(_port_graph(jg), n_shards)
    for name in PG_ARRAYS:
        a, b = np.asarray(getattr(jpg, name)), _np(getattr(tpg, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for spec in ("halo_in", "halo_out"):
        js, ts = getattr(jpg, spec), getattr(tpg, spec)
        assert (js.n_ghost, js.pair_cap) == (ts.n_ghost, ts.pair_cap), spec
        for name in ("ghost_ids", "send_local", "recv_pos"):
            a, b = np.asarray(getattr(js, name)), _np(getattr(ts, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), (spec, name)
    for name in ("n_vertices", "n_edges", "n_shards", "v_max", "e_max"):
        assert getattr(jpg, name) == getattr(tpg, name), name
    # the port's CSR offsets: segment s of shard r is rows ptr[s]:ptr[s+1]
    for key, ptr in (("dst_l", "in_ptr_l"), ("t_src_l", "out_ptr_l")):
        keys, offs = _np(getattr(tpg, key)), _np(getattr(tpg, ptr))
        assert offs.dtype == np.int32 and offs.shape == (n_shards, tpg.v_max + 1)
        for r in range(n_shards):
            assert np.array_equal(
                offs[r], np.searchsorted(keys[r], np.arange(tpg.v_max + 1))
            ), (ptr, r)
    # the field shuffles
    rng = np.random.default_rng(0)
    for x in (
        rng.normal(size=jg.n_vertices).astype(np.float32),
        rng.integers(0, 100, jg.n_vertices).astype(np.int32),
        rng.random(jg.n_vertices) < 0.5,
    ):
        want = np.asarray(JP.partition_field(jpg, jnp.asarray(x)))
        got = TP.partition_field(tpg, torch.from_numpy(x))
        assert np.array_equal(_np(got), want)
        assert np.array_equal(_np(TP.unpartition_field(tpg, got)), x)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_stats_match_jax(graph):
    jg = GRAPHS[graph]()
    tg = _port_graph(jg)
    for n_shards in (1, 4):
        assert TP.partition_stats(TP.partition_graph(tg, n_shards)) == JP.partition_stats(
            JP.partition_graph(jg, n_shards)
        )
        assert TP.comm_bytes_report(tg, n_shards) == JP.comm_bytes_report(jg, n_shards)
        got = TP.byte_cost_model(tg, n_shards, request_set=7, combined_request_set=3)
        want = JP.byte_cost_model(jg, n_shards, request_set=7, combined_request_set=3)
        assert repr(got) == repr(want)
    idx = np.random.default_rng(1).integers(-2, jg.n_vertices + 2, 50).astype(np.int32)
    assert TP.request_dedup_report(torch.from_numpy(idx), jg.n_vertices) == (
        JP.request_dedup_report(jnp.asarray(idx), jg.n_vertices)
    )


def test_bench_partition_figures_reproduced():
    """``BENCH_palgol_mesh.json``'s per-graph reports at S = 8 — the
    512×8 grid (halo_total 112, pair_cap 8) and the scale-12 R-MAT."""
    graphs = {
        "grid_512x8": TG.grid2d(512, 8, device="cpu"),
        "rmat_s12": TG.rmat(12, avg_degree=8.0, directed=True, seed=5, device="cpu"),
    }
    n_shards = BENCH["n_shards"]
    for name, g in graphs.items():
        assert TP.comm_bytes_report(g, n_shards) == BENCH["per_graph"][name], name
    grid = BENCH["per_graph"]["grid_512x8"]["partition"]
    assert (grid["halo_total"], grid["halo_pair_cap"]) == (112, 8)


def test_bench_gather_dedup_reproduced():
    """The request-dedup figures of ``BENCH_palgol_mesh.json``: S-V's final
    ``D`` (64 → 3 slots) and chain4's random indirection field (64 → 39),
    on the benchmark's small graph, through the port's own run."""
    small = TG.erdos_renyi(64, 4.0, directed=False, weighted=True, seed=0, device="cpu")
    per_algo = BENCH["schedules"]["per_algo"]
    out, _, _ = torch_compile(talg.SV, small).run()
    assert TP.request_dedup_report(out["D"], small.n_vertices) == per_algo["sv"]["gather_dedup"]
    d = np.random.default_rng(0).integers(0, 64, 64).astype(np.int32)
    assert TP.request_dedup_report(torch.from_numpy(d), 64) == per_algo["chain4"]["gather_dedup"]
    assert (per_algo["sv"]["gather_dedup"]["deduped_request_slots"],
            per_algo["chain4"]["gather_dedup"]["deduped_request_slots"]) == (3, 39)


# -- one shard, in process ----------------------------------------------------

SINGLE_SHARD = ["sssp", "wcc", "sv", "mwm", "chain4", "mis", "bipartite_matching", "bool_comb"]


def _single_shard_case(name):
    """tests/test_partition.py's graph and initial fields for one program."""
    fields = None
    if name == "sssp":
        g = JG.erdos_renyi(40, 4.0, directed=True, weighted=True, seed=3)
    elif name == "chain4":
        g = JG.erdos_renyi(30, 2.0, directed=False, seed=3)
        fields = {"D": np.random.default_rng(3).integers(0, 30, 30).astype(np.int32)}
    elif name == "mis":
        g = JG.erdos_renyi(40, 3.0, directed=False, seed=3)
        fields = {"P": np.random.default_rng(3).random(40).astype(np.float32)}
    elif name == "bipartite_matching":
        g, side = JG.random_bipartite(15, 15, 3.0, seed=3)
        fields = {"Side": np.asarray(side)}
    elif name == "bool_comb":
        g = JG.erdos_renyi(40, 3.0, directed=False, seed=5)
    else:
        g = JG.erdos_renyi(40, 3.0, directed=False, weighted=True, seed=3)
    return g, fields


def _jax_init(name, g, fields):
    jfields = None if fields is None else {k: jnp.asarray(v) for k, v in fields.items()}
    cp = jax_compile(PROGRAMS[name], g, initial_fields=jfields)
    return cp, {k: np.asarray(v) for k, v in cp.init_fields(jfields).items()}


def _assert_result(key, want, got):
    """Fields exact (f32 within TOL), supersteps, trips and frontiers equal."""
    fields, steps, trips, active = want
    assert (got["supersteps"], got["trips"], got["active_sets"]) == (steps, trips, active), key
    assert set(got["fields"]) == set(fields), key
    for f, a in fields.items():
        b = got["fields"][f]
        assert a.dtype == b.dtype and a.shape == b.shape, (key, f)
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, **TOL, err_msg=f"{key}.{f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{key}.{f}")


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("schedule", ["pull", "push", "naive"])
@pytest.mark.parametrize("name", SINGLE_SHARD)
def test_single_shard_matches_jax(name, schedule, fuse):
    g, fields = _single_shard_case(name)
    cp, f0 = _jax_init(name, g, fields)
    jres = jax_run_bsp(
        cp.prog, g, {k: jnp.asarray(v) for k, v in f0.items()}, schedule=schedule,
        placement="partitioned", n_shards=1, fuse=fuse,
    )
    want = (
        {k: np.asarray(v) for k, v in jres.fields.items()},
        jres.supersteps, jres.trips, jres.active_sets,
    )
    res = torch_run_bsp(
        torch_parse(PROGRAMS[name]), _port_graph(g), f0, schedule=schedule,
        placement="partitioned", n_shards=1, fuse=fuse,
    )
    got = dict(
        fields={k: _np(v) for k, v in res.fields.items()},
        supersteps=res.supersteps, trips=res.trips, active_sets=res.active_sets,
    )
    _assert_result((name, schedule, fuse), want, got)


@pytest.mark.parametrize("regime", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["sv", "chain4"])
def test_single_shard_auto_matches_jax(name, regime):
    """``schedule="auto"`` on byte costs built from the layout by each
    package's ``byte_cost_model`` (the sparse regime makes it pick push)."""
    g, fields = _single_shard_case(name)
    cp, f0 = _jax_init(name, g, fields)
    kw = {} if regime == "dense" else dict(request_set=4, combined_request_set=1)
    jres = jax_run_bsp(
        cp.prog, g, {k: jnp.asarray(v) for k, v in f0.items()}, schedule="auto",
        placement="partitioned", n_shards=1,
        byte_costs=JP.byte_cost_model(g, 1, **kw),
    )
    want = (
        {k: np.asarray(v) for k, v in jres.fields.items()},
        jres.supersteps, jres.trips, jres.active_sets,
    )
    tg = _port_graph(g)
    res = torch_run_bsp(
        torch_parse(PROGRAMS[name]), tg, f0, schedule="auto",
        placement="partitioned", n_shards=1,
        byte_costs=TP.byte_cost_model(tg, 1, **kw),
    )
    got = dict(
        fields={k: _np(v) for k, v in res.fields.items()},
        supersteps=res.supersteps, trips=res.trips, active_sets=res.active_sets,
    )
    _assert_result((name, "auto", regime), want, got)


# -- eight gloo ranks ----------------------------------------------------------

#: (program, schedule) cases of the eight-rank run
MULTI_RANK = [
    (name, "pull") for name in ("sssp", "wcc", "sv", "chain4", "mwm", "bool_comb")
] + [(name, s) for name in ("sv", "chain4") for s in ("push", "naive")]


def _multi_rank_case(name):
    """tests/test_partition.py's eight-device graphs and fields."""
    fields = None
    if name == "sssp":
        g = JG.erdos_renyi(48, 4.0, directed=True, weighted=True, seed=3)
    elif name == "chain4":
        g = JG.erdos_renyi(32, 2.0, directed=False, seed=3)
        fields = {"D": np.random.default_rng(3).integers(0, 32, 32).astype(np.int32)}
    else:
        g = JG.erdos_renyi(48, 3.0, directed=False, weighted=True, seed=3)
    return g, fields


@pytest.mark.subprocess_mesh
def test_partitioned_eight_gloo_ranks(tmp_path):
    """Eight gloo ranks on the CPU: the programs equal the JAX package's
    (whose eight-device partitioned run equals its dense run,
    tests/test_partition.py), and the three collectives equal the dense
    ``graph.ops`` result on every shard (checked inside the ranks)."""
    cases, want = {}, {}
    for name, schedule in MULTI_RANK:
        g, fields = _multi_rank_case(name)
        cp, f0 = _jax_init(name, g, fields)
        jres = jax_run_bsp(
            cp.prog, g, {k: jnp.asarray(v) for k, v in f0.items()}, schedule=schedule
        )
        key = f"{name}/{schedule}"
        want[key] = (
            {k: np.asarray(v) for k, v in jres.fields.items()},
            jres.supersteps, jres.trips, jres.active_sets,
        )
        cases[key] = dict(
            source=PROGRAMS[name], schedule=schedule, n=g.n_vertices, fields=f0,
            graph={k: np.asarray(getattr(g, k)) for k in TS.EDGE_ARRAYS},
        )
    with open(tmp_path / "cases.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_partition_ranks.py"),
         str(tmp_path / "cases.pkl"), str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with open(tmp_path / "programs.pkl", "rb") as fh:
        got = pickle.load(fh)
    assert set(got) == set(want)
    for key in want:
        _assert_result(key, want[key], got[key])


# -- refusals, as the JAX package's -------------------------------------------


def _wcc_case():
    g = TG.cycle(8, device="cpu")
    cp = torch_compile(talg.WCC, g)
    return g, cp


def test_rejects_unknown_schedule():
    g, cp = _wcc_case()
    with pytest.raises(ValueError):
        torch_run_bsp(
            cp.prog, g, cp.init_fields(), schedule="bogus",
            placement="partitioned", n_shards=1,
        )


def test_rejects_more_shards_than_the_group():
    """No process group is one rank: two shards are refused, as JAX's
    ``shard_mesh`` refuses more shards than devices."""
    g, cp = _wcc_case()
    with pytest.raises(ValueError, match="exceeds"):
        torch_run_bsp(cp.prog, g, cp.init_fields(), placement="partitioned", n_shards=2)
    with pytest.raises(ValueError, match="exceeds"):
        shard_mesh(2, device="cpu")


def test_rejects_more_shards_than_vertices():
    g = TG.cycle(4, device="cpu")
    with pytest.raises(ValueError):
        TP.edge_balanced_ranges(g, 5)
    with pytest.raises(ValueError):
        TP.partition_graph(g, 5)


def test_partitioned_entry_defaults_to_the_card(monkeypatch):
    """A partition is placed on ``cuda`` unless the caller names a device:
    without a card that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, cp = _wcc_case()
    pg = TP.partition_graph(g, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_run_bsp(cp.prog, pg, cp.init_fields(), placement="partitioned")
    with pytest.raises(RuntimeError, match="cuda"):
        shard_mesh(1)
    res = torch_run_bsp(
        cp.prog, pg, cp.init_fields(), placement="partitioned",
        mesh=shard_mesh(1, device="cpu"),
    )
    want = torch_run_bsp(cp.prog, g, cp.init_fields())
    assert torch.equal(res.fields["C"], want.fields["C"])
    assert res.supersteps == want.supersteps
