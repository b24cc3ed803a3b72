"""``placement="partitioned"`` execution of Palgol programs.

The port of ``repro.graph.partition.executor``. ``run_bsp_partitioned`` is
the partitioned twin of :func:`repro_torch.pregel.runtime.run_bsp`: the
same host-side program-plan walk (:func:`~repro_torch.pregel.runtime.walk_plan`
— Seq/Iter/Stop sequencing, fixed-point aggregator round-trips, fused
superstep counting, frontier instrumentation), with each **fused
superstep** executed by every shard's process on its own block of the
:class:`~repro_torch.graph.partition.partitioner.PartitionedGraph`. The
JAX package runs a superstep as one ``shard_map`` call; here one process
per shard runs the same body (SPMD over ``torch.distributed``): the
unchanged :class:`~repro_torch.core.codegen.StepExecutor` executes one plan
op at a time (:func:`~repro_torch.core.codegen.exec_plan_part`) with a
:class:`ShardComm`, which maps ops onto the halo collectives:

* ``ReadRound`` for neighborhood sends (``F[e.id]``) → static
  :func:`~.halo.halo_exchange` (moves only boundary state);
* ``ReadRound`` for chain accesses (``D[D[u]]``) →
  :func:`~.halo.gather_global` — once per pull round, once per hop under
  ``schedule="naive"``, once per ``push_reply`` round under
  ``schedule="push"``;
* ``RemoteUpdate`` → :func:`~.halo.scatter_reduce` + a local fold at the
  owner.

A *merged* superstep of the fused plan (§4.3) runs its parts in order in
one superstep, and the per-shard mailbox (chain/neighborhood buffers,
pending remote payloads) crosses superstep boundaries as this process's
own dict. The fixed-point check all-reduces the frontier over the group,
so every rank takes the same branch and the recorded ``active_sets`` are
global counts.

On the card, every remote read and every local reduction goes through
``graph.ops``, so through the two kernels: ``gather_rows`` serves the
halo's send gather, the owner-side gather of ``gather_global`` and the
neighbour reads over the extended ``[v_max + n_ghost]`` table;
``segment_reduce`` the shard's reductions over ``v_max`` segments.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import plan as plan_mod
from repro_torch.core.codegen import HALTED, _EdgeCtx, exec_plan_part
from repro_torch.core.plan import ByteCostModel
from repro_torch.dist.sharding import ShardMesh, shard_mesh
from repro_torch.graph import ops as gops
from repro_torch.graph.partition import halo
from repro_torch.graph.partition.partitioner import (
    PartitionedGraph,
    partition_field,
    partition_graph,
    unpartition_field,
)
from repro_torch.graph.structure import Graph, as_field
from repro_torch.pregel.runtime import BSPResult, walk_plan


class ShardComm:
    """One shard's communication context.

    Implements the addressing contract of
    :class:`~repro_torch.core.codegen.StepExecutor`: ``n_rows`` local rows
    per shard (``v_max``), global vertex ids as values, halo-layer
    collectives for every access that leaves the shard. ``pg`` is this
    shard's view (:meth:`PartitionedGraph.shard`).
    """

    def __init__(self, pg: PartitionedGraph, rank: int, group=None):
        self.pg = pg
        self.group = group
        self.n_rows = pg.v_max
        self.valid = pg.vmask
        self.start = int(pg.starts[rank])
        self._vid: Dict[str, torch.Tensor] = {}

    def ids(self) -> torch.Tensor:
        """Global ids of this shard's rows (padding rows run past the
        range; they are masked inactive everywhere)."""
        return torch.arange(
            self.start, self.start + self.n_rows, dtype=torch.int32,
            device=self.valid.device,
        )

    def gather(self, arr: torch.Tensor, idx: torch.Tensor, fill=None) -> torch.Tensor:
        """``arr[idx]`` for arbitrary *global* ids (dynamic exchange)."""
        idx = gops.to_int32(idx).to(arr.device)
        flat = halo.gather_global(
            arr, idx.reshape(-1), self.pg.starts, self.pg.n_vertices,
            self.pg.v_max, fill=fill, group=self.group,
        )
        return flat.reshape(idx.shape + arr.shape[1:])

    def _halo_for(self, direction: str):
        return self.pg.halo_in if direction in ("in", "nbr") else self.pg.halo_out

    def read_edge(self, per_row: torch.Tensor, ectx: _EdgeCtx) -> torch.Tensor:
        """Per-edge neighbor values via the static halo (boundary-only)."""
        spec = self._halo_for(ectx.direction)
        ghost = halo.halo_exchange(
            per_row, spec.send_local, spec.recv_pos, spec.n_ghost, self.group
        )
        ext = torch.cat([per_row, ghost]) if spec.n_ghost else per_row
        return gops.gather(ext, ectx.nbr_read)

    def edge_ctx(self, direction: str) -> _EdgeCtx:
        pg = self.pg
        if direction in ("in", "nbr"):
            seg, nbr_g, nbr_h, w, m, ptr = (
                pg.dst_l, pg.src_g, pg.src_h, pg.w, pg.emask, pg.in_ptr_l,
            )
        elif direction == "out":
            seg, nbr_g, nbr_h, w, m, ptr = (
                pg.t_src_l, pg.t_dst_g, pg.t_dst_h, pg.t_w, pg.t_emask,
                pg.out_ptr_l,
            )
        else:
            raise ValueError(f"unknown edge direction {direction!r}")
        key = "in" if direction == "nbr" else direction
        if key not in self._vid:  # the global id of each edge's own vertex
            self._vid[key] = seg + self.start
        return _EdgeCtx(
            direction, nbr=nbr_g, vid=self._vid[key], w=w, emask=m,
            offsets=ptr, seg=seg, nbr_read=nbr_h,
        )

    def scatter_reduce(self, idx, values, op: str, mask) -> torch.Tensor:
        """Pre-combined remote-write delta for this shard's owned rows."""
        return halo.scatter_reduce(
            gops.to_int32(idx), values, op, self.pg.starts,
            self.pg.n_vertices, self.pg.v_max, mask=mask, group=self.group,
        )


def _all_gather(block: torch.Tensor, group) -> torch.Tensor:
    """Every shard's ``[v_max, ...]`` block → ``[S, v_max, ...]`` on every
    rank."""
    if group is None:
        return block[None]
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, block.contiguous(), group=group)
    return torch.stack(parts)


def run_bsp_partitioned(
    prog,
    graph,
    fields: Dict[str, torch.Tensor],
    schedule: str = "pull",
    max_iters: int = 100_000,
    mesh: Optional[ShardMesh] = None,
    n_shards: Optional[int] = None,
    group=None,
    byte_costs: Optional[ByteCostModel] = None,
    fuse: bool = True,
) -> BSPResult:
    """Execute a Palgol program over partitioned vertex state.

    Same contract as :func:`repro_torch.pregel.runtime.run_bsp` (canonical
    field dict in, final *dense* fields + superstep count + trips +
    frontier sizes out, on every rank); every rank of the group calls it.
    ``graph`` is a dense :class:`~repro_torch.graph.structure.Graph`,
    partitioned here, or a :class:`PartitionedGraph` built once by
    :func:`partition_graph` (each rank takes its own shard of it).
    ``mesh`` (:func:`repro_torch.dist.shard_mesh`) places the shards;
    without one, ``n_shards`` and ``group`` give it, on the dense graph's
    device or, for a partition, on ``cuda``. Every schedule runs here
    (``pull``/``push``/``naive``/``auto`` — build byte costs from this
    layout with :func:`repro_torch.graph.partition.byte_cost_model`), and
    ``fuse=True`` (default) executes the §4.3-fused program plan;
    ``fuse=False`` the unfused per-op expansion.
    """
    pp = plan_mod.lower_program(prog, schedule=schedule, byte_costs=byte_costs)
    if fuse:
        pp = plan_mod.fuse(pp)

    if mesh is None:
        device = graph.device if isinstance(graph, Graph) else "cuda"
        mesh = shard_mesh(n_shards, group, device)
    if isinstance(graph, PartitionedGraph):
        pg = graph
        if pg.n_shards != mesh.n_shards:
            raise ValueError(
                f"a partition of {pg.n_shards} shards on {mesh.n_shards} ranks"
            )
    else:
        pg = partition_graph(graph, mesh.n_shards)
    view = pg.shard(mesh.rank, mesh.device)
    comm = ShardComm(view, mesh.rank, mesh.group)

    fields = {k: as_field(v, mesh.device) for k, v in fields.items()}
    if HALTED not in fields:
        fields[HALTED] = torch.zeros(
            (graph.n_vertices,), dtype=torch.bool, device=mesh.device
        )
    local = {k: partition_field(pg, v)[mesh.rank] for k, v in fields.items()}

    counter = [0]
    trips: List[int] = []
    active_sets: List[List[int]] = []
    mailbox_box = [{}]

    def exec_superstep(ss: plan_mod.Superstep, flds):
        mbox = mailbox_box[0]
        for ref in ss.parts:
            flds, mbox = exec_plan_part(ref, view, comm, flds, mbox)
        mailbox_box[0] = mbox
        return flds

    out = walk_plan(
        pp, local, exec_superstep, counter, trips, max_iters,
        active_sets=active_sets, group=mesh.group,
    )
    dense = {
        k: unpartition_field(pg, _all_gather(v, mesh.group)) for k, v in out.items()
    }
    return BSPResult(
        fields=dense, supersteps=counter[0], trips=trips, active_sets=active_sets,
    )
