"""k-hop uniform neighbor sampler (GraphSAGE-style minibatches).

The JAX package's ``repro.graph.sampler`` on torch tensors: given seed
nodes and per-hop fanouts, draw uniform in-neighbor samples from the CSR
adjacency and emit a *padded, statically-shaped* sampled block per hop.
Zero-degree nodes sample the sentinel (== n_vertices) with mask False, and
so does every row of a sentinel ("dead") frontier node.

The random draw and the selection are separate: :func:`draw_offsets` draws
``r [B, fanout]`` uniform in ``[0, max(degree, 1))`` from an explicit
``torch.Generator`` (another stream than ``jax.random``), and
:func:`_select` turns any such draws into the block exactly as the JAX
sampler does (``start + r`` read with ``take(mode="clip")``, the degree-0
sentinel and mask, the dead-frontier rule). Indices stay int32; the reads
of ``indptr`` and ``indices`` go through ``graph.ops.gather``, so on the
card they run ``kernels.gather_rows``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.graph import ops as gops
from repro_torch.models.common import fake_tensor


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One hop of sampled neighborhood.

    ``nodes``:   i32[B]            destination nodes of this hop
    ``neighbors``: i32[B, fanout]  sampled in-neighbors (sentinel-padded)
    ``mask``:    bool[B, fanout]
    """

    nodes: torch.Tensor
    neighbors: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CSR:
    """Host-built CSR adjacency (in-neighbors), on the graph's device."""

    indptr: torch.Tensor  # i32[N+1]
    indices: torch.Tensor  # i32[nnz]
    n_vertices: int

    @staticmethod
    def from_graph(graph) -> "CSR":
        """Built with numpy on the host, as the JAX package builds it."""
        dst = graph.dst.cpu().numpy()
        src = graph.src.cpu().numpy()
        m = graph.edge_mask.cpu().numpy()
        dst, src = dst[m], src[m]
        order = np.argsort(dst, kind="stable")
        dst, src = dst[order], src[order]
        counts = np.bincount(dst, minlength=graph.n_vertices)
        indptr = np.zeros(graph.n_vertices + 1, np.int32)
        np.cumsum(counts, out=indptr[1:])
        dev = graph.device
        return CSR(torch.from_numpy(indptr).to(dev),
                   torch.from_numpy(src.astype(np.int32)).to(dev), graph.n_vertices)


def _span(csr: CSR, nodes: torch.Tensor):
    """(start, degree) of each node's in-neighbor run, the nodes clamped
    into range (a sentinel frontier entry reads the last node's run). Both
    ``indptr`` reads follow JAX's ``x[ids]``: an id in ``[-(N+1), -1]``
    wraps over the N + 1 entries, then the clip-mode gather clamps."""
    safe = torch.clamp(nodes, max=csr.n_vertices - 1)
    start = gops.gather(csr.indptr, _wrap(safe, csr.n_vertices + 1))
    return start, gops.gather(csr.indptr, _wrap(safe + 1, csr.n_vertices + 1)) - start


def _wrap(ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(ids < 0, ids + n, ids)


def draw_offsets(csr: CSR, nodes: torch.Tensor, fanout: int,
                 gen: torch.Generator) -> torch.Tensor:
    """Uniform draws ``i32[B, fanout]`` in ``[0, max(degree, 1))`` for each
    node's in-neighbor run, from ``gen`` (on the nodes' device)."""
    _, degree = _span(csr, nodes)
    hi = torch.clamp(degree, min=1).to(torch.float64)[:, None]
    u = torch.rand((nodes.shape[0], fanout), generator=gen, dtype=torch.float64,
                   device=nodes.device)
    return torch.minimum(torch.floor(u * hi), hi - 1).to(torch.int32)


def _select(csr: CSR, frontier: torch.Tensor, r: torch.Tensor) -> SampledBlock:
    """The block of ``frontier`` for the draws ``r [B, fanout]``: neighbor
    ``indices[clip(start + r)]``, the sentinel where the node has no
    in-neighbor or is itself the sentinel, and the mask of the rest."""
    n = csr.n_vertices
    start, degree = _span(csr, frontier)
    neighbors = gops.gather(csr.indices, start[:, None] + r)  # clip mode
    alive = (degree > 0) & (frontier < n)
    mask = alive[:, None].expand(neighbors.shape)
    neighbors = torch.where(mask, neighbors, n)
    return SampledBlock(nodes=frontier, neighbors=neighbors, mask=mask.contiguous())


def sample_neighbors(csr: CSR, nodes: torch.Tensor, fanout: int,
                     gen: torch.Generator) -> SampledBlock:
    """Uniform-with-replacement sample of ``fanout`` in-neighbors per node."""
    return _select(csr, nodes, draw_offsets(csr, nodes, fanout, gen))


def sample_khop(csr: CSR, seeds: torch.Tensor, fanouts: Sequence[int],
                gen: torch.Generator) -> List[SampledBlock]:
    """Multi-hop sampling: returns one SampledBlock per hop, innermost last.

    Hop ``i`` samples ``fanouts[i]`` neighbors for every frontier node; the
    next frontier is the flattened neighbor set (with replacement — standard
    GraphSAGE). Output shapes are fully static:
      hop0: nodes [B],      neighbors [B, f0]
      hop1: nodes [B*f0],   neighbors [B*f0, f1]
      ...
    """
    blocks = []
    frontier = seeds
    for f in fanouts:
        blk = sample_neighbors(csr, frontier, f, gen)
        blocks.append(blk)
        frontier = blk.neighbors.reshape(-1)
    return blocks


def sampled_input_shapes(batch_nodes: int, fanouts: Sequence[int], d_feat: int,
                         device="cuda"):
    """Fake tensors of a sampled minibatch's features and masks (the JAX
    package's ``sampled_input_shapes``, for the dry-run)."""
    shapes = {}
    b = batch_nodes
    shapes["seed_feats"] = fake_tensor((b, d_feat), torch.float32, device)
    for i, f in enumerate(fanouts):
        shapes[f"hop{i}_feats"] = fake_tensor((b * f, d_feat), torch.float32, device)
        shapes[f"hop{i}_mask"] = fake_tensor((b, f), torch.bool, device)
        b = b * f
    return shapes
