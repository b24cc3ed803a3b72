"""Shiloach-Vishkin connectivity on the PyTorch/CUDA port (paper Fig. 6).

    PYTHONPATH=src python examples/torch_connected_components.py              # on the card
    PYTHONPATH=src python examples/torch_connected_components.py --device cpu

``examples/connected_components.py`` on ``repro_torch``: the chain access
``D[D[u]]`` compiled by the logic system (§4.1.1), the remote accumulative
write ``remote D[D[u]] <?= t``, and the three execution regimes — the
fused whole program, the staged BSP runtime with the pull schedule, and
staged BSP with the unfused naive request/reply schedule (the hand-written
code stand-in) — which must give the same labels.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import compile_program
from repro_torch.core.logic import pull_rounds, push_rounds
from repro_torch.graph import generators as G
from repro_torch.pregel import run_bsp


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def run(device="cuda"):
    """S-V on the example's R-MAT under the three regimes: ``{"D", "trips",
    "counts", "pull", "naive", "seconds"}`` (``pull``/``naive`` the
    ``BSPResult``s; the labels asserted equal)."""
    g = G.rmat(11, avg_degree=6, directed=False, seed=3, device=device)
    dev = g.device
    cp = compile_program(alg.SV, g)
    (out, trips, counts), t_fused = _timed(cp.run, dev)
    D = out["D"].cpu().numpy()
    f0 = cp.init_fields()
    bsp_pull, t_pull = _timed(lambda: run_bsp(cp.prog, g, f0, schedule="pull"), dev)
    # the manual-style baseline keeps the unfused request/reply expansion
    bsp_naive, t_naive = _timed(
        lambda: run_bsp(cp.prog, g, f0, schedule="naive", fuse=False), dev)
    assert np.array_equal(D, bsp_pull.fields["D"].cpu().numpy())
    assert np.array_equal(D, bsp_naive.fields["D"].cpu().numpy())
    return {"graph": g, "D": D, "trips": trips, "counts": counts, "pull": bsp_pull,
            "naive": bsp_naive, "seconds": (t_fused, t_pull, t_naive)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("chain-access compilation (paper §4.1.1):")
    for k in (2, 3, 4, 8):
        pat = ("D",) * k
        print(f"  D^{k}[u]: paper push schedule = {push_rounds(pat)} rounds,"
              f" pull schedule = {pull_rounds(pat)} rounds,"
              f" naive request/reply = {2 * (k - 1)} rounds")
    res = run(args.device)
    counts, (t_fused, t_pull, t_naive) = res["counts"], res["seconds"]
    print(f"\ngraph: {res['graph'].n_vertices} vertices")
    print(f"components: {len(np.unique(res['D']))}; iterations: {res['trips'][0]}")
    print("\nexecution regimes (identical results):")
    print(f"  fused dense (palgol):   {counts['palgol_push']:3d} supersteps"
          f" (accounted) {t_fused * 1e3:9.1f} ms")
    print(f"  staged BSP, pull:       {res['pull'].supersteps:3d} supersteps"
          f" (executed)  {t_pull * 1e3:9.1f} ms")
    print(f"  staged BSP, naive:      {res['naive'].supersteps:3d} supersteps"
          f" (executed)  {t_naive * 1e3:9.1f} ms")
    red = 100 * (1 - counts["palgol_push"] / counts["naive"])
    print(f"\nsuperstep reduction vs naive: {red:.1f}% "
          "(paper reports 46.5–51.7% for S-V)")
    return res


if __name__ == "__main__":
    main()
