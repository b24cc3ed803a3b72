"""Quickstart on the PyTorch/CUDA port: write a Palgol program, compile it,
run it on a graph.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``examples/quickstart.py`` on ``repro_torch``. Single-source shortest path
(the paper's Fig. 4), end to end: parse → analyse remote-access patterns →
compile the fused plan → execute (the remote reads through
``kernels.gather_rows``, the message combining through
``kernels.segment_reduce`` on the card) → superstep accounting, checked
against the per-vertex reference interpreter.
"""

import argparse

import numpy as np

from repro_torch.core import algorithms as alg
from repro_torch.core import compile_program, interpret
from repro_torch.graph import generators as G


def run(device="cuda"):
    """SSSP on the quickstart's R-MAT: ``{"graph", "D", "trips", "counts",
    "reference"}`` (``D`` and ``reference`` as numpy; the assertion held)."""
    # a weighted power-law digraph (RMAT, ~1k vertices)
    g = G.rmat(10, avg_degree=8, directed=True, weighted=True, seed=7, device=device)
    cp = compile_program(alg.SSSP, g)
    out, trips, counts = cp.run()
    D = out["D"].cpu().numpy()
    # cross-check against the per-vertex reference interpreter
    ref, _ = interpret(alg.SSSP, g)
    assert np.allclose(D, ref["D"], rtol=1e-4, equal_nan=True)
    return {"graph": g, "D": D, "trips": trips, "counts": counts, "reference": ref["D"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    g, D = res["graph"], res["D"]
    print(f"graph: {g.n_vertices} vertices, {int(g.edge_mask.sum())} edges")
    print("\n--- Palgol source (paper Fig. 4) ---")
    print(alg.SSSP.strip())
    finite = np.isfinite(D)
    print(f"\nreachable vertices: {finite.sum()}; "
          f"max distance: {D[finite].max():.3f}; iterations: {res['trips'][0]}")
    print("\nsuperstep accounting (paper Table 5 analogue):")
    for k, v in res["counts"].items():
        print(f"  {k:12} {v}")
    print("\noracle check: compiled result == naive interpreter ✓")
    return res


if __name__ == "__main__":
    main()
