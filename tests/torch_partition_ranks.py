"""Eight gloo ranks on the CPU running the port's partitioned placement.

    python tests/torch_partition_ranks.py CASES.pkl OUT_DIR

Helper of ``tests/test_torch_partition.py`` (not a test module itself: it
imports only ``torch`` and the port, never ``jax``). ``CASES.pkl`` holds
the program cases — source text, schedule, the graph's sorted edge arrays
and the initial fields as numpy — written by the test from the JAX
package's generators. Every rank joins one gloo group over
``tcp://localhost:<port>`` and

* runs every program case through ``run_bsp(placement="partitioned")``;
  rank 0 writes the dense results to ``OUT_DIR/programs.pkl``;
* holds ``halo_exchange``, ``gather_global`` (dedup on and off, ``fill``
  set and unset, ids −1 and N) and ``scatter_reduce`` (all six combiners,
  a mask, out-of-range targets) on its own shard against the dense
  ``graph.ops`` result, and raises on the first disagreement.

A rank that raises makes ``torch.multiprocessing.spawn`` raise, so the
script exits non-zero.
"""

from __future__ import annotations

import pickle
import socket
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

WORLD = 8
TOL = dict(rtol=2e-5, atol=2e-5)  # f32 TOL of tests/test_kernels.py


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _graph(arrays, n):
    from repro_torch.graph import structure as TS

    return TS.from_arrays(**arrays, n_vertices=n, device="cpu")


def _check(what, got, want):
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL, msg=what)
    elif not torch.equal(got, want):
        raise AssertionError(f"{what}: {got.tolist()} != {want.tolist()}")


def _unit_cases(rank):
    """The collectives on shard ``rank`` against dense ``graph.ops``."""
    from repro_torch.graph import generators as G
    from repro_torch.graph import ops as gops
    from repro_torch.graph.partition import halo, partition_field, partition_graph

    group = dist.group.WORLD
    g = G.erdos_renyi(61, 3.0, directed=True, seed=11, device="cpu")
    n = g.n_vertices
    pg = partition_graph(g, WORLD)
    view = pg.shard(rank)
    lo, hi = int(pg.starts[rank]), int(pg.starts[rank + 1])
    rng = np.random.default_rng(7)  # the same draws on every rank
    x = torch.from_numpy(rng.integers(-50, 50, n).astype(np.int32))
    block = partition_field(pg, x)[rank]

    for spec in (view.halo_in, view.halo_out):
        ghost = halo.halo_exchange(
            block, spec.send_local, spec.recv_pos, spec.n_ghost, group
        )
        ids = spec.ghost_ids
        want = torch.where(ids < n, gops.gather(x, ids), 0)
        _check("halo_exchange", ghost, want)

    # every rank's requests, drawn alike; ids −1 and N included
    reqs = [
        torch.from_numpy(rng.integers(-1, n + 1, 40).astype(np.int32))
        for _ in range(WORLD)
    ]
    idx = reqs[rank]
    idx[:2] = torch.tensor([-1, n], dtype=torch.int32)
    for fill in (None, 7):
        want = gops.gather(x, idx)
        if fill is not None:  # across shards every id outside [0, N) reads fill
            want = torch.where((idx < 0) | (idx >= n), fill, want)
        for dedup in (True, False):
            got = halo.gather_global(
                block, idx, view.starts, n, pg.v_max, fill=fill, group=group,
                dedup=dedup,
            )
            _check(f"gather_global fill={fill} dedup={dedup}", got, want)

    k = 50
    targets = [
        torch.from_numpy(rng.integers(-3, n + 3, k).astype(np.int32))
        for _ in range(WORLD)
    ]
    masks = [torch.from_numpy(rng.random(k) < 0.8) for _ in range(WORLD)]
    payload = {
        torch.int32: [torch.from_numpy(rng.integers(-9, 9, k).astype(np.int32))
                      for _ in range(WORLD)],
        torch.float32: [torch.from_numpy(rng.normal(size=k).astype(np.float32))
                        for _ in range(WORLD)],
        torch.bool: [torch.from_numpy(rng.random(k) < 0.5) for _ in range(WORLD)],
    }
    for op, dtypes in (
        ("sum", (torch.int32, torch.float32)),
        ("prod", (torch.int32, torch.float32)),
        ("min", (torch.int32, torch.float32)),
        ("max", (torch.int32, torch.float32)),
        ("or", (torch.bool,)),
        ("and", (torch.bool,)),
    ):
        for dtype in dtypes:
            for use_mask in (False, True):
                dense = torch.full((n,), gops._identity_for(op, dtype), dtype=dtype)
                for r in range(WORLD):
                    # across shards a negative target is dropped, where the
                    # dense scatter wraps [-N, -1] (the JAX package's rule)
                    dense = gops.scatter_combine(
                        dense, torch.where(targets[r] < 0, n, targets[r]),
                        payload[dtype][r], op,
                        mask=masks[r] if use_mask else None,
                    )
                want = torch.full((pg.v_max,), gops._identity_for(op, dtype), dtype=dtype)
                want[: hi - lo] = dense[lo:hi]
                got = halo.scatter_reduce(
                    targets[rank], payload[dtype][rank], op, view.starts, n,
                    pg.v_max, mask=masks[rank] if use_mask else None, group=group,
                )
                _check(f"scatter_reduce {op} {dtype} mask={use_mask}", got, want)


def _rank(rank, port, cases_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=WORLD
    )
    try:
        from repro_torch.core import parse
        from repro_torch.pregel import run_bsp

        with open(cases_path, "rb") as fh:
            cases = pickle.load(fh)
        results = {}
        for key, case in cases.items():
            res = run_bsp(
                parse(case["source"]), _graph(case["graph"], case["n"]),
                case["fields"], schedule=case["schedule"], placement="partitioned",
            )
            results[key] = dict(
                fields={k: v.numpy() for k, v in res.fields.items()},
                supersteps=res.supersteps, trips=res.trips,
                active_sets=res.active_sets,
            )
        if rank == 0:
            with open(Path(out_dir) / "programs.pkl", "wb") as fh:
                pickle.dump(results, fh)
        _unit_cases(rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(_free_port(), sys.argv[1], sys.argv[2]), nprocs=WORLD)
