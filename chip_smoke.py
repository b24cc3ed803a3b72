#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # Graph500 R-MAT, scale 22, edgefactor 16

What it does, in order, and fails on the first thing that is wrong:

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel of ``src/repro_torch/csrc`` from the checkout (one ``nvcc``
   per source, all at once) into the ignored ``src/repro_torch/build/``;
2. holds each kernel against its plain PyTorch version on the card over a
   sweep of dtypes, widths, negative/sentinel indices, empty segments,
   masks and every combiner (exact, float sums/products within the f32 /
   bf16 tolerances of tests/test_kernels.py);
3. drives the main path — ``compile_program`` → ``run_bsp`` — on a
   Graph500 R-MAT of scale 22 (4.19 M vertices, 67 M directed edges; about
   twice that once symmetrised, the soc-LiveJournal1 class of graph that
   Pregel systems are evaluated on): Shiloach-Vishkin (pull and push
   schedules) and WCC on the symmetric graph, SSSP and PageRank on the
   directed weighted one, plus ``cp.run()`` for WCC. Each result is held
   against an independent host oracle (scipy connected components, scipy
   Dijkstra, a float64 numpy PageRank), each superstep count against the
   plan's cost model, and both kernels' launch counters must be non-zero;
4. times each kernel at the main path's shapes beside its bound, its plain
   version and the one PyTorch call that computes the same function, and
   measures the device's busy share over one program run.

Every number is printed beside the card's name and power limit. The line
before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data sheet: HBM3 rate and the non-tensor-core f32 rate (also
#: used for int32 ops, the same units)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: tests/test_kernels.py TOL
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def say(kind: str, card: str, **fields):
    print(kind, json.dumps({**fields, "card": card}), flush=True)


# -- 2. kernels against their plain versions ---------------------------------


def check_kernels(device, gen):
    """Each kernel against its plain version over a sweep; returns the
    number of cases per kernel."""
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.kernels import (
        gather_rows, gather_rows_plain, segment_reduce, segment_reduce_plain,
    )

    cases = {"gather_rows": 0, "segment_reduce": 0}
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
        for shape in ((1000,), (1000, 5), (300, 40), (70_000,)):
            table = torch.randn(shape, generator=gen) * 10
            table = (table > 0) if dt == torch.bool else table.to(dt)
            v = shape[0]
            idx = torch.randint(-2 * v, 2 * v, (7777,), generator=gen, dtype=torch.int32)
            idx[:4] = torch.tensor([-1, v, v + 1, -v - 1])  # negative, sentinel
            for fill in (None, True if dt == torch.bool else -3):
                got = gather_rows(table.to(device), idx.to(device), fill).cpu()
                want = gather_rows_plain(table, idx, fill)
                if not torch.equal(got, want):
                    raise AssertionError(f"gather_rows {dt} {shape} fill={fill}")
                cases["gather_rows"] += 1
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
        ops = ("min", "max", "or", "and") if dt == torch.bool else ("sum", "prod", "min", "max")
        for op in ops:
            for width in (1, 3, 40):
                n, e = 600, 9000
                ids = torch.randint(-3, n + 3, (e,), generator=gen, dtype=torch.int32)
                ids[(ids > 100) & (ids < 140)] = 150  # empty segments
                ids = torch.sort(ids).values
                vals = torch.randn((e, width) if width > 1 else (e,), generator=gen)
                if dt == torch.bool:
                    vals = vals > 0
                elif op == "prod":
                    vals = (1.0 + 0.05 * vals).to(dt) if dt != torch.int32 else (
                        vals.sign().to(dt)
                    )
                else:
                    vals = (vals * 100).to(dt)
                if dt.is_floating_point:  # a NaN must reach its segment's result
                    vals.view(e, -1)[torch.randint(0, e, (5,), generator=gen), 0] = float("nan")
                for mask in (None, torch.rand(e, generator=gen) < 0.8):
                    off = segment_offsets(ids, n)
                    got = segment_reduce(
                        vals.to(device), ids.to(device), n, op,
                        mask=None if mask is None else mask.to(device),
                        offsets=off.to(device),
                    ).cpu()
                    want = segment_reduce_plain(vals, ids, n, op, mask=mask)
                    if dt in TOL and op in ("sum", "prod"):
                        torch.testing.assert_close(
                            got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt],
                            equal_nan=True,
                        )
                    elif dt in TOL:  # min/max: exact, NaN where the plain one has NaN
                        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
                    elif not torch.equal(got, want):
                        raise AssertionError(f"segment_reduce {dt} {op} width={width}")
                    cases["segment_reduce"] += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    return cases


# -- 3. the main path and its oracles ------------------------------------------


def host_csr(graph):
    """(indptr, indices, data) of the out-edges (``t_*`` ordering) on the
    host, padding rows dropped (they sort last)."""
    n = graph.n_vertices
    ptr = graph.out_ptr.cpu().numpy().astype(np.int64)
    e = int(ptr[n])
    return ptr, graph.t_dst[:e].cpu().numpy(), graph.t_weight[:e].cpu().numpy()


def oracle_components(graph):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    ptr, idx, w = host_csr(graph)
    n = graph.n_vertices
    m = sp.csr_matrix((np.ones_like(w), idx, ptr), shape=(n, n))
    return connected_components(m, directed=False)[1]


def same_partition(labels, oracle) -> bool:
    a = np.unique(labels, return_inverse=True)[1].astype(np.int64)
    b = oracle.astype(np.int64)
    pairs = np.unique(a * (b.max() + 1) + b).size
    return pairs == np.unique(a).size == np.unique(b).size


def min_id_per_component(oracle):
    n = oracle.shape[0]
    out = np.full(oracle.max() + 1, n, np.int64)
    np.minimum.at(out, oracle, np.arange(n))
    return out[oracle]


def oracle_sssp(graph):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    # parallel edges stay as duplicate entries, which Dijkstra must treat
    # as alternatives: check that on a three-vertex graph first
    tiny = sp.csr_matrix(
        (np.array([5.0, 1.0, 1.0]), np.array([1, 1, 2]), np.array([0, 2, 3, 3])),
        shape=(3, 3),
    )
    if not np.array_equal(dijkstra(tiny, indices=0), [0.0, 1.0, 2.0]):
        raise AssertionError("scipy dijkstra does not take the cheaper parallel edge")
    ptr, idx, w = host_csr(graph)
    n = graph.n_vertices
    m = sp.csr_matrix((w.astype(np.float64), idx, ptr), shape=(n, n))
    return dijkstra(m, directed=True, indices=0)


def oracle_pagerank(graph, rounds: int = 30):
    """float64 power iteration of the PageRank program: dangling mass
    dropped, parallel edges counted with their multiplicity."""
    import scipy.sparse as sp

    ptr, idx, _ = host_csr(graph)
    n = graph.n_vertices
    deg = np.diff(ptr).astype(np.float64)
    src = np.repeat(np.arange(n), np.diff(ptr))
    a = sp.csr_matrix((np.ones(idx.shape[0]), (idx, src)), shape=(n, n))
    pr = np.full(n, 1.0 / n)
    for _ in range(rounds):
        share = np.divide(pr, deg, out=np.zeros(n), where=deg > 0)
        pr = 0.15 / n + 0.85 * (a @ share)
    return pr


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed_run(cp, graph, schedule, device):
    """One ``run_bsp`` of a compiled program, timed on the host clock up to
    the card's last kernel."""
    from repro_torch.pregel import run_bsp

    f0 = cp.init_fields()
    sync(device)
    t0 = time.perf_counter()
    res = run_bsp(cp.prog, graph, f0, schedule=schedule)
    sync(device)
    return res, time.perf_counter() - t0


def run_program(name, source, graph, schedule, device, card):
    """compile_program → run_bsp; checks the superstep count against the
    plan's cost model and reports wall time (the first run in this process,
    so it includes one-time loading of the library kernels it touches)."""
    from repro_torch.core import compile_program

    cp = compile_program(source, graph, schedule=schedule)
    res, wall = timed_run(cp, graph, schedule, device)
    key = {"pull": "palgol_pull", "push": "palgol_push"}[schedule]
    planned = cp.cost_models[key].count(res.trips)
    if res.supersteps != planned:
        raise AssertionError(f"{name}/{schedule}: {res.supersteps} supersteps, plan {planned}")
    say(
        "program", card, name=name, schedule=schedule, wall_s=wall,
        supersteps=res.supersteps, trips=res.trips,
        n_vertices=graph.n_vertices, n_edges=graph.n_edges,
    )
    return cp, res


def main_path(scale, edgefactor, seed, device, card):
    """Build the graphs, then run the programs with the launch counters
    zeroed just before and read just after."""
    from repro_torch.core import algorithms as alg
    from repro_torch.graph import generators as G
    from repro_torch.kernels import gather_rows, segment_reduce

    t0 = time.perf_counter()
    sym = G.rmat(scale, edgefactor, directed=False, seed=seed, device=device)
    dirw = G.rmat(scale, edgefactor, directed=True, weighted=True, seed=seed, device=device)
    sync(device)
    say(
        "graphs", card, setup_s=time.perf_counter() - t0, scale=scale,
        edgefactor=edgefactor, n_vertices=sym.n_vertices,
        symmetric_edges=sym.n_edges, directed_edges=dirw.n_edges,
    )

    gather_rows.launches = 0
    segment_reduce.launches = 0
    runs = [
        ("sv", alg.SV, sym, "pull"),
        ("sv", alg.SV, sym, "push"),
        ("wcc", alg.WCC, sym, "pull"),
        ("sssp", alg.SSSP, dirw, "pull"),
        ("pagerank", alg.PAGERANK, dirw, "pull"),
    ]
    compiled = [run_program(*r, device, card) for r in runs]
    (_, sv_pull), (_, sv_push), (wcc_cp, wcc), (_, sssp), (_, pr) = compiled
    t0 = time.perf_counter()
    dense, dense_trips, dense_counts = wcc_cp.run()
    sync(device)
    say(
        "program", card, name="wcc", schedule="pull", entry="cp.run()",
        wall_s=time.perf_counter() - t0, supersteps=dense_counts["palgol_pull"],
        trips=dense_trips,
    )
    launches = {
        "gather_rows": gather_rows.launches,
        "segment_reduce": segment_reduce.launches,
    }
    say("launches", card, **launches)
    for k, v in launches.items():
        if v <= 0 and device.type == "cuda":
            raise AssertionError(f"the main path never launched {k}")

    # steady state: every program once more, with every kernel loaded
    for (name, _, graph, schedule), (cp, first) in zip(runs, compiled):
        res, wall = timed_run(cp, graph, schedule, device)
        if res.supersteps != first.supersteps:
            raise AssertionError(f"{name}/{schedule}: a rerun took other supersteps")
        say(
            "program_warm", card, name=name, schedule=schedule, wall_s=wall,
            supersteps=res.supersteps, ms_per_superstep=wall * 1e3 / res.supersteps,
        )
    if dense_trips != wcc.trips or not torch.equal(dense["C"], wcc.fields["C"]):
        raise AssertionError("wcc: cp.run() and run_bsp disagree")
    if sv_pull.supersteps >= sv_push.supersteps:
        raise AssertionError("S-V: pull should take fewer supersteps than push")
    t0 = time.perf_counter()
    comp = oracle_components(sym)
    for label, res in (("sv/pull", sv_pull), ("sv/push", sv_push)):
        d = res.fields["D"].cpu().numpy()
        if not same_partition(d, comp):
            raise AssertionError(f"{label}: components differ from scipy")
    c = wcc.fields["C"].cpu().numpy()
    if not np.array_equal(c, min_id_per_component(comp)):
        raise AssertionError("wcc: labels are not the minimum id of each component")
    dist = oracle_sssp(dirw)
    got = sssp.fields["D"].cpu().numpy().astype(np.float64)
    if not np.array_equal(np.isinf(got), np.isinf(dist)):
        raise AssertionError("sssp: reachable sets differ from scipy dijkstra")
    fin = np.isfinite(dist)
    np.testing.assert_allclose(got[fin], dist[fin], rtol=1e-5, atol=0)
    ref = oracle_pagerank(dirw)
    np.testing.assert_allclose(
        pr.fields["PR"].cpu().numpy().astype(np.float64), ref, rtol=1e-4, atol=0
    )
    say(
        "oracles", card, ok=True, check_s=time.perf_counter() - t0,
        components=int(comp.max() + 1), sssp_reached=int(fin.sum()),
        pagerank_sum=float(ref.sum()),
    )
    return launches, (sym, dirw), (sv_pull, sv_push, wcc, sssp, pr)


# -- 4. kernel times ------------------------------------------------------------


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, nops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_rows(graphs, launches):
    """Each kernel at the main path's shapes: its time, the plain version's,
    the library call's, its bound and its error against the plain version."""
    from repro_torch.graph import ops as gops
    from repro_torch.kernels import (
        gather_rows, gather_rows_plain, segment_reduce, segment_reduce_plain,
    )

    sym, dirw = graphs
    n = sym.n_vertices
    # gather: WCC's neighbour read C[e.id] — an int32 field at every edge
    table = torch.randperm(n, device="cuda").to(torch.int32)
    idx = sym.src
    got = gather_rows(table, idx)
    if not torch.equal(got, gather_rows_plain(table, idx)):
        raise AssertionError("gather_rows disagrees with its plain version")
    err_g = (got - gather_rows_plain(table, idx)).abs().max().item()
    g_bytes = table.numel() * 4 + idx.numel() * 4 + got.numel() * 4
    g_bound, g_by = bound(g_bytes, 0)
    rows = [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "src/repro_torch/csrc/gather_rows.cu",
        "replaces": "src/repro/kernels/gather_rows/kernel.py:20",
        "launches": launches["gather_rows"],
        "max_abs_err": float(err_g),
        "ms": cuda_ms(lambda: gather_rows(table, idx)),
        "plain_ms": cuda_ms(lambda: gather_rows_plain(table, idx)),
        "bound_ms": g_bound,
        "bound_by": g_by,
        "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx)),
        "shape": f"table i32[{n}], idx i32[{idx.numel()}]",
    }]

    # segment reduce: WCC's minimum [C[e.id] | e <- Nbr[v]] over the
    # symmetric graph, and PageRank's float sum over In[v] of the directed one
    vals = gops.gather(table, sym.src)
    mask = sym.edge_mask
    got = segment_reduce(vals, sym.dst, n, "min", mask=mask, offsets=sym.in_ptr)
    want = segment_reduce_plain(vals, sym.dst, n, "min", mask=mask)
    if not torch.equal(got, want):
        raise AssertionError("segment_reduce disagrees with its plain version")
    err = (got.long() - want.long()).abs().max().item()
    # values k/16 in [0, 1): every partial sum below 2**20 is exact in f32,
    # so the sum cannot depend on the order and the check is exact; a
    # dropped edge or a zeroed segment changes it by at least 1/16
    fvals = torch.randint(0, 16, (dirw.n_edges,), device="cuda").float() / 16
    fgot = segment_reduce(fvals, dirw.dst, n, "sum", mask=dirw.edge_mask, offsets=dirw.in_ptr)
    fwant = segment_reduce_plain(fvals, dirw.dst, n, "sum", mask=dirw.edge_mask)
    if fwant.max().item() >= 2**20:
        raise AssertionError("a segment sum reaches 2**20: f32 sums are no longer exact")
    torch.testing.assert_close(fgot, fwant, rtol=0, atol=0)
    err = max(err, (fgot - fwant).abs().max().item())
    e = vals.numel()
    s_bytes = e * 4 + e + (n + 1) * 4 + n * 4
    s_bound, s_by = bound(s_bytes, e)
    ids64 = sym.dst.long()
    ident = torch.full((n,), torch.iinfo(torch.int32).max, dtype=torch.int32, device="cuda")
    rows.append({
        "name": "segment_reduce",
        "route": "cuda",
        "source": "src/repro_torch/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce/kernel.py:55",
        "launches": launches["segment_reduce"],
        "max_abs_err": float(err),
        "ms": cuda_ms(
            lambda: segment_reduce(vals, sym.dst, n, "min", mask=mask, offsets=sym.in_ptr)
        ),
        "plain_ms": cuda_ms(lambda: segment_reduce_plain(vals, sym.dst, n, "min", mask=mask)),
        "bound_ms": s_bound,
        "bound_by": s_by,
        "library_ms": cuda_ms(
            lambda: ident.scatter_reduce(0, ids64, vals, "amin", include_self=True)
        ),
        "shape": f"values i32[{e}] min, mask, {n} segments",
    })
    return rows


def busy_share(graph, card):
    """Device busy share over one WCC run under torch.profiler: the union
    of the card's activity intervals over the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import algorithms as alg
    from repro_torch.core import compile_program
    from repro_torch.pregel import run_bsp

    cp = compile_program(alg.WCC, graph)
    f0 = cp.init_fields()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_bsp(cp.prog, graph, f0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (ev.time_range.start, ev.time_range.end)
        for ev in prof.events()
        if ev.device_type == DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    share = busy / wall_us if spans else None
    say(
        "device_busy", card, program="wcc", supersteps=res.supersteps,
        wall_ms_profiled=wall_us / 1e3, device_busy_ms=busy / 1e3,
        busy_share=share, idle_share=None if share is None else 1 - share,
        device_events=len(spans),
    )


def main() -> int:
    scale, edgefactor, seed = 22, 16.0, 0  # Graph500 R-MAT at scale 22
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import build  # fails beside no checkout: no result

    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    reports = build.build()
    say("build", card, seconds=time.perf_counter() - t0, built=sorted(reports))
    for name, log in reports.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", log)]
        say(
            "ptxas", card, kernel=name, instantiations=len(regs),
            max_registers=max(regs, default=0), spill_store_bytes=sum(spills),
        )

    gen = torch.Generator().manual_seed(seed)
    cases = check_kernels(device, gen)
    say("kernel_check", card, ok=True, cases=cases, versus="plain PyTorch versions")

    launches, graphs, _ = main_path(scale, edgefactor, seed, device, card)
    rows = kernel_rows(graphs, launches)
    busy_share(graphs[0], card)
    say("memory", card, peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
