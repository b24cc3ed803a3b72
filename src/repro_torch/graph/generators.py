"""Synthetic graph generators (host-side numpy, deterministic by seed).

Real deployments load partitioned edge lists from distributed storage; these
generators stand in for the loader in tests/benchmarks and reproduce the
qualitative degree distributions of the paper's datasets (power-law social
graphs) at laptop scale.

The edge lists are the JAX package's (``repro.graph.generators``), draw for
draw; each generator returns the port's :class:`Graph` on ``device``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph, from_edge_list, symmetrize


def chain(n: int, weighted: bool = False, seed: int = 0, device="cuda") -> Graph:
    """Path graph 0→1→…→n-1 (directed)."""
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    w = None
    if weighted:
        rng = np.random.default_rng(seed)
        w = rng.uniform(0.5, 2.0, size=src.shape).astype(np.float32)
    return from_edge_list(src, dst, n, w, device=device)


def cycle(n: int, device="cuda") -> Graph:
    src = np.arange(n, dtype=np.int32)
    dst = (src + 1) % n
    return from_edge_list(src, dst, n, device=device)


def star(n: int, device="cuda") -> Graph:
    """Undirected star: hub 0 connected to 1..n-1."""
    src = np.zeros(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    s, d, w = symmetrize(src, dst)
    return from_edge_list(s, d, n, w, device=device)


def grid2d(rows: int, cols: int, device="cuda") -> Graph:
    """Undirected 2D grid."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    src = np.concatenate([right[0], down[0]])
    dst = np.concatenate([right[1], down[1]])
    s, d, w = symmetrize(src, dst)
    return from_edge_list(s, d, rows * cols, w, device=device)


def erdos_renyi(
    n: int,
    avg_degree: float = 8.0,
    directed: bool = False,
    weighted: bool = False,
    seed: int = 0,
    device="cuda",
) -> Graph:
    """G(n, m) random graph with m ≈ n*avg_degree(/2 if undirected)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree) if directed else int(n * avg_degree / 2)
    src = rng.integers(0, n, size=m, dtype=np.int32)
    dst = rng.integers(0, n, size=m, dtype=np.int32)
    keep = src != dst  # no self loops
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.1, 10.0, size=src.shape).astype(np.float32) if weighted else None
    if directed:
        return from_edge_list(src, dst, n, w, device=device)
    s, d, w2 = symmetrize(src, dst, w)
    return from_edge_list(s, d, n, w2, device=device)


def rmat(
    n_log2: int,
    avg_degree: float = 16.0,
    directed: bool = True,
    weighted: bool = False,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    device="cuda",
) -> Graph:
    """R-MAT power-law generator (Graph500 parameters by default).

    Matches the skewed degree distributions of LJ/Facebook/Wikipedia used in
    the paper's evaluation.
    """
    n = 1 << n_log2
    m = int(n * avg_degree)
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(n_log2):
        r = rng.random(m)
        # quadrant probabilities a,b,c,d
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.astype(np.int64) << level
        dst |= go_right.astype(np.int64) << level
    keep = src != dst
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    w = rng.uniform(0.1, 10.0, size=src.shape).astype(np.float32) if weighted else None
    if directed:
        return from_edge_list(src, dst, n, w, device=device)
    s, d, w2 = symmetrize(src, dst, w)
    return from_edge_list(s, d, n, w2, device=device)


def random_bipartite(
    n_left: int, n_right: int, avg_degree: float = 4.0, seed: int = 0,
    device="cuda",
):
    """Undirected bipartite graph; returns (graph, side) where side[v]∈{0,1}."""
    rng = np.random.default_rng(seed)
    m = int((n_left + n_right) * avg_degree / 2)
    left = rng.integers(0, n_left, size=m, dtype=np.int32)
    right = rng.integers(0, n_right, size=m, dtype=np.int32) + n_left
    s, d, w = symmetrize(left, right)
    n = n_left + n_right
    side = np.zeros(n, dtype=np.int32)
    side[n_left:] = 1
    return from_edge_list(s, d, n, w, device=device), side


def forest_pointers(n: int, n_trees: int = 4, seed: int = 0) -> np.ndarray:
    """Random parent-pointer forest (for chain-access tests): D[u] = parent."""
    rng = np.random.default_rng(seed)
    parent = np.arange(n, dtype=np.int32)
    roots = rng.choice(n, size=n_trees, replace=False)
    for u in range(n):
        if u in roots:
            continue
        # point to a random smaller-indexed vertex to keep it acyclic-ish; or a root
        parent[u] = (
            rng.choice(roots) if rng.random() < 0.3 else rng.integers(0, max(u, 1))
        )
    return parent
