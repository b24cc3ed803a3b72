"""Partitioned vertex state with halo exchange (``repro_torch.graph.partition``).

The port of ``repro.graph.partition``. Instead of every process holding
every vertex field, the vertex id space is split into contiguous,
edge-balanced ranges — one per shard, one shard per process of a
``torch.distributed`` group — and each superstep moves only *boundary*
state:

* :mod:`~repro_torch.graph.partition.partitioner` — the edge-balanced
  greedy prefix-split partitioner and :class:`PartitionedGraph` (per-shard
  local COO with remapped local ids and CSR offsets, static halo indices,
  owner maps);
* :mod:`~repro_torch.graph.partition.halo` — the collectives:
  ``halo_exchange`` (static ghost reads), ``gather_global`` (dynamic
  request/reply reads), ``scatter_reduce`` (combiner-aware reduce-scatter
  for remote writes);
* :mod:`~repro_torch.graph.partition.executor` — ``run_bsp_partitioned``:
  the ``placement="partitioned"`` path of ``repro_torch.pregel.run_bsp``;
* :mod:`~repro_torch.graph.partition.stats` — communication accounting,
  and ``byte_cost_model`` for the byte-aware ``auto`` schedule selector.
"""

from repro_torch.graph.partition.partitioner import (  # noqa: F401
    HaloSpec,
    PartitionedGraph,
    edge_balanced_ranges,
    partition_field,
    partition_fields,
    partition_graph,
    unpartition_field,
    unpartition_fields,
)
from repro_torch.graph.partition.executor import (  # noqa: F401
    run_bsp_partitioned,
)
from repro_torch.graph.partition.stats import (  # noqa: F401
    byte_cost_model,
    comm_bytes_report,
    partition_stats,
    request_dedup_report,
)
