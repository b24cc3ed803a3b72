"""Standard library of Palgol programs (paper §5.3's algorithm list).

Each entry is Palgol *source text* — parsed, analyzed, and compiled like any
user program. Coverage vs the paper's Table:

| algorithm | status |
|---|---|
| PageRank (PR)                     | ``PAGERANK`` |
| Single-Source Shortest Path       | ``SSSP`` |
| Shiloach-Vishkin connectivity     | ``SV`` (paper Fig. 6 verbatim) |
| Weakly Connected Components       | ``WCC`` (HashMin) |
| Randomized Bipartite Matching     | ``BIPARTITE_MATCHING`` (priority-det.) |
| Approx. Max Weight Matching (MWM) | ``MWM`` (uses chain access + stop) |
| Maximal Independent Set / Coloring| ``MIS`` (Luby-style, priority input) |
| Strongly Connected Components     | ``SCC`` (fwd/bwd label propagation) |
| Triangle Counting (TC)            | not DSL-expressible without list-valued
|                                   | messages (needs the FFI the paper
|                                   | mentions); provided as a substrate op in
|                                   | ``repro.graph`` instead — see DESIGN.md |
| Bi-Connected Components (BCC)     | needs vertex addition — unsupported in
|                                   | Palgol (paper §5.2), as in the paper |

Required initial fields are documented per program (e.g. ``P`` random
priorities for MIS, ``Side`` for bipartite matching).
"""

SSSP = """
# Single-source shortest path from vertex 0 (paper Fig. 4).
for v in V
    local D[v] := (Id[v] == 0 ? 0.0 : inf)
    local A[v] := (Id[v] == 0)
end
do
    for v in V
        let minDist = minimum [D[e.id] + e.w | e <- In[v], A[e.id]]
        local A[v] := false
        if (minDist < D[v])
            local A[v] := true
            local D[v] := minDist
    end
until fix [D]
"""

SV = """
# Shiloach-Vishkin connectivity (paper Fig. 6, verbatim semantics).
for u in V
    local D[u] := Id[u]
end
do
    for u in V
        if (D[D[u]] == D[u])
            let t = minimum [D[e.id] | e <- Nbr[u]]
            if (t < D[u])
                remote D[D[u]] <?= t
        else
            local D[u] := D[D[u]]
    end
until fix [D]
"""

PAGERANK = """
# PageRank, 30 rounds, damping 0.85; dangling mass dropped.
for v in V
    local Deg[v] := count [1 | e <- Out[v]]
    local PR[v] := 1.0 / numV
end
do
    for v in V
        let s = sum [PR[e.id] / Deg[e.id] | e <- In[v], Deg[e.id] > 0]
        local PR[v] := 0.15 / numV + 0.85 * s
    end
until iter [30]
"""

WCC = """
# Weakly connected components via HashMin label propagation.
for v in V
    local C[v] := Id[v]
end
do
    for v in V
        let m = minimum [C[e.id] | e <- Nbr[v]]
        if (m < C[v])
            local C[v] := m
    end
until fix [C]
"""

MIS = """
# Luby-style maximal independent set. Input field: P (random priorities).
for v in V
    local InMIS[v] := false
    local Done[v] := false
end
do
    for v in V
        if (!Done[v])
            let better = or [true | e <- Nbr[v], !Done[e.id] && ((P[e.id] < P[v]) || (P[e.id] == P[v] && Id[e.id] < Id[v]))]
            if (!better)
                local InMIS[v] := true
                local Done[v] := true
    end
    for v in V
        if (!Done[v])
            let nbrIn = or [InMIS[e.id] | e <- Nbr[v]]
            if (nbrIn)
                local Done[v] := true
    end
until fix [Done]
"""

BIPARTITE_MATCHING = """
# Bipartite matching, priority-deterministic variant of the paper's BM.
# Input field: Side (0 = left, 1 = right). M == numV means unmatched.
for v in V
    local M[v] := numV
    local Req[v] := numV
end
do
    for v in V
        if (Side[v] == 0 && M[v] == numV)
            let target = minimum [e.id | e <- Nbr[v], M[e.id] == numV]
            if (target < numV)
                remote Req[target] <?= Id[v]
    end
    for v in V
        if (Side[v] == 1 && M[v] == numV && Req[v] < numV)
            local M[v] := Req[v]
            remote M[Req[v]] <?= Id[v]
        local Req[v] := numV
    end
until fix [M]
"""

MWM = """
# Approximate maximum weight matching (Salihoglu-Widom MWM): point at the
# best unmatched neighbor; mutual pointers match. Uses a chain access
# (Cand[Cand[v]]) and vertex inactivation for matched pairs.
for v in V
    local M[v] := numV
    local Cand[v] := numV
end
do
    for v in V
        if (M[v] == numV)
            local Cand[v] := argmax [e.w | e <- Nbr[v], M[e.id] == numV]
    end
    for v in V
        if (M[v] == numV && Cand[v] < numV)
            if (Cand[Cand[v]] == Id[v])
                local M[v] := Cand[v]
    end
    stop v in V if M[v] < numV
until fix [M]
"""

SCC = """
# Strongly connected components via forward-backward label propagation:
# color = (min forward-reachable id, min backward-reachable id); vertices
# agreeing on both labels with a pivot form one SCC per round (simplified
# label-propagation SCC; full Yan et al. SCC adds graph shrinking).
for v in V
    local F[v] := Id[v]
    local B[v] := Id[v]
end
do
    for v in V
        let mf = minimum [F[e.id] | e <- In[v]]
        if (mf < F[v])
            local F[v] := mf
    end
until fix [F]
do
    for v in V
        if (F[v] == Id[v])
            local B[v] := Id[v]
        else
            let mb = minimum [B[e.id] | e <- Out[v], F[e.id] == F[v]]
            if (mb < B[v])
                local B[v] := mb
    end
until fix [B]
for v in V
    local SCCid[v] := (B[v] == F[v] ? F[v] : numV + Id[v])
end
"""

# the chain-access stress program from paper §4.1.1 (D⁴[u] in 3 rounds)
CHAIN4 = """
for u in V
    local D4[u] := D[D[D[D[u]]]]
end
"""

BFS = """
# BFS level from vertex 0 (unweighted shortest hop count).
for v in V
    local L[v] := (Id[v] == 0 ? 0 : inf)
end
do
    for v in V
        let m = minimum [L[e.id] + 1.0 | e <- In[v]]
        if (m < L[v])
            local L[v] := m
    end
until fix [L]
"""

KCORE = """
# k-core decomposition (peeling): iteratively drop vertices with active
# degree < k; Alive marks the k-core membership. Input field: K (constant).
for v in V
    local Alive[v] := true
end
do
    for v in V
        if (Alive[v])
            let deg = count [1 | e <- Nbr[v], Alive[e.id]]
            if (deg < K[v])
                local Alive[v] := false
    end
until fix [Alive]
"""

LABEL_PROP = """
# Label propagation communities (synchronous min-label compromise: adopt
# the smallest label among self and neighbors weighted by none — a
# deterministic LPA variant that converges under fix).
for v in V
    local C[v] := Id[v]
end
do
    for v in V
        let best = minimum [C[e.id] | e <- Nbr[v]]
        if (best < C[v])
            local C[v] := best
    end
until fix [C]
"""

ALL = {
    "sssp": SSSP,
    "sv": SV,
    "pagerank": PAGERANK,
    "wcc": WCC,
    "mis": MIS,
    "bipartite_matching": BIPARTITE_MATCHING,
    "mwm": MWM,
    "scc": SCC,
    "chain4": CHAIN4,
    "bfs": BFS,
    "kcore": KCORE,
    "label_prop": LABEL_PROP,
}
