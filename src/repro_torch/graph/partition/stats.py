"""Communication accounting: replicated vs partitioned bytes per superstep.

The replicated scheme (``repro.graph.ops`` mp_* path) keeps every vertex
field on every chip; a superstep's neighbor aggregation produces a full
``[N]`` partial per shard that one ring all-reduce combines — each device
moves ``2·(S-1)/S·N`` values regardless of how local the graph is.

The partitioned scheme moves only the halo: each ghost value travels once
from its owner to each reader. Two figures are reported —

* ``payload`` — the real entries exchanged (sum of per-(owner, reader)
  halo counts); what an ideal variable-length transport would move;
* ``padded`` — what our static-shape ``all_to_all`` actually moves
  (``S² · pair_cap`` values), the honest figure for this implementation.

Both are per *one f32-field pull superstep*; multiply by live field count
and dtype width for a program-level estimate. ``benchmarks/palgol_mesh.py``
serializes this report to ``BENCH_palgol_mesh.json``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.plan import ByteCostModel
from repro_torch.graph.partition.partitioner import (
    PartitionedGraph,
    partition_graph,
)


def partition_stats(pg: PartitionedGraph) -> Dict:
    """Structural invariant summary of one partition."""
    starts = np.asarray(pg.starts, dtype=np.int64)
    sizes = starts[1:] - starts[:-1]
    pull_counts = np.asarray(pg.emask).sum(axis=1)
    push_counts = np.asarray(pg.t_emask).sum(axis=1)
    ghosts_in = (np.asarray(pg.halo_in.ghost_ids) < pg.n_vertices).sum(axis=1)
    ghosts_out = (np.asarray(pg.halo_out.ghost_ids) < pg.n_vertices).sum(axis=1)
    return {
        "n_vertices": pg.n_vertices,
        "n_edges": pg.n_edges,
        "n_shards": pg.n_shards,
        "v_max": pg.v_max,
        "e_max": pg.e_max,
        "shard_sizes": sizes.tolist(),
        "pull_edges_per_shard": pull_counts.tolist(),
        "push_edges_per_shard": push_counts.tolist(),
        "halo_in_per_shard": ghosts_in.tolist(),
        "halo_out_per_shard": ghosts_out.tolist(),
        "halo_total": int(ghosts_in.sum()),
        "halo_pair_cap": pg.halo_in.pair_cap,
    }


def comm_bytes_report(
    graph,
    n_shards: int,
    bytes_per_value: int = 4,
    pg: Optional[PartitionedGraph] = None,
) -> Dict:
    """Bytes moved per pull superstep, replicated vs partitioned.

    Aggregate across all devices, for one f32 vertex field:

    * replicated: ring all-reduce of the ``[N]`` partials —
      ``S · 2·(S-1)/S · N·b = 2·(S-1)·N·b``;
    * partitioned payload: each real halo entry moved once, owner→reader;
    * partitioned padded: the static-shape ``all_to_all`` cost,
      ``S²·pair_cap·b``.
    """
    if pg is None:
        pg = partition_graph(graph, n_shards)
    stats = partition_stats(pg)
    n, b, S = pg.n_vertices, bytes_per_value, pg.n_shards
    replicated = 2 * (S - 1) * n * b
    payload = stats["halo_total"] * b
    padded = S * S * pg.halo_in.pair_cap * b
    return {
        "partition": stats,
        "bytes_per_value": b,
        "replicated_bytes_per_superstep": replicated,
        "partitioned_payload_bytes_per_superstep": payload,
        "partitioned_padded_bytes_per_superstep": padded,
        # None (JSON null) when the halo is empty — float('inf') would
        # serialize as the non-standard `Infinity` token
        "reduction_vs_replicated": (
            None if padded == 0 else replicated / padded
        ),
        "vertices_per_halo_entry": (
            None
            if stats["halo_total"] == 0
            else n / stats["halo_total"]
        ),
    }


def request_dedup_report(
    idx,
    n_vertices: int,
    bytes_per_value: int = 4,
    reply_width: int = 1,
) -> Dict:
    """Measured wire effect of ``gather_global``'s request dedup pass.

    ``idx`` is one round's request set (a chain-access indirection field,
    e.g. S-V's ``D``). ``raw`` is one slot per live requester — what the
    pre-dedup bucketing shipped; ``deduped`` is one slot per *distinct*
    target — what the unique-pass ships now. The gap is the modeled
    combining advantage (``combined_request_set``) turned into measured
    bytes: requests ship ids, replies ship ``reply_width`` values each.
    """
    idx = np.asarray(idx)
    live = idx[(idx >= 0) & (idx < n_vertices)]
    raw = int(live.size)
    ded = int(np.unique(live).size)
    per_slot = bytes_per_value * (1 + reply_width)  # request id + reply
    return {
        "raw_request_slots": raw,
        "deduped_request_slots": ded,
        "raw_bytes": raw * per_slot,
        "deduped_bytes": ded * per_slot,
        "dedup_factor": None if ded == 0 else raw / ded,
    }


def byte_cost_model(
    graph,
    n_shards: int,
    bytes_per_value: int = 4,
    pg: Optional[PartitionedGraph] = None,
    request_set: Optional[int] = None,
    combined_request_set: Optional[int] = None,
    superstep_overhead_bytes: int = 0,
) -> ByteCostModel:
    """Instrument a :class:`~repro.core.plan.ByteCostModel` from the
    partitioned layout — the plug between this layer's measured structure
    and the plan IR's byte-aware ``auto`` selector.

    * ``halo_bytes`` — the static halo payload one neighborhood round
      actually moves (``partition_stats``'s per-(owner, reader) counts);
    * ``update_bytes`` — one remote-write reduce-scatter, charged at the
      same halo payload (remote writes in the stdlib target neighbors or
      chain endpoints, both boundary-shaped);
    * ``request_set`` — live requesters per dynamic chain round. Defaults
      to ``n_vertices`` (every vertex reads its chain — the dense dryrun
      regime); pass a measured active-set size (e.g. the frontier of a
      converging pointer-jumping round, or ``halo_total`` for a
      boundary-only access pattern) to model the sparse regimes where
      naive/push beat pull;
    * ``combined_request_set`` — requesters after message combining
      (push); defaults to ``request_set``.
    """
    if pg is None:
        pg = partition_graph(graph, n_shards)
    stats = partition_stats(pg)
    halo_bytes = stats["halo_total"] * bytes_per_value
    return ByteCostModel(
        n_vertices=pg.n_vertices,
        value_bytes=bytes_per_value,
        request_set=request_set,
        combined_request_set=combined_request_set,
        halo_bytes=halo_bytes,
        update_bytes=halo_bytes,
        superstep_overhead_bytes=superstep_overhead_bytes,
    )
