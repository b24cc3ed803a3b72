"""Synthetic data pipelines (deterministic, seeded).

The port's half of ``repro.data.pipeline``: the LM token stream, the
recsys generator and the full-graph GNN batch, with the JAX package's
numpy draws, so that one seed gives the same batches in both packages
(each returned as tensors on ``device``), and the sampled GraphSAGE
minibatches, drawn from an explicit ``torch.Generator`` (another stream
than ``jax.random``), whose feature reads run ``kernels.gather_rows`` on
the card.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.graph import generators as G
from repro_torch.graph import ops as gops
from repro_torch.graph.sampler import CSR, sample_khop
from repro_torch.graph.structure import resolve_device


def token_batches(
    batch: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    device="cuda",
) -> Iterator[dict]:
    """LM batches: next-token labels over a synthetic Zipf(1.3) token
    stream, int32 ``tokens``/``labels [B, S]`` (the JAX package's draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        # Zipf-ish distribution to give the embedding gather realistic skew
        toks = (rng.zipf(1.3, size=(batch, seq_len + 1)) % vocab).astype(np.int32)
        yield {
            "tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev),
        }


def recsys_batches(
    batch: int,
    n_fields: int,
    vocab: int,
    seed: int = 0,
    device="cuda",
) -> Iterator[dict]:
    """CTR batches: Zipf(1.2) field ids (int32 ``fields [B, F]``) and
    labels (float32 ``[B]``) from a synthetic signal on two fields."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        fields = rng.zipf(1.2, size=(batch, n_fields)) % vocab
        # synthetic CTR signal: depends on a few field hashes
        logit = ((fields[:, 0] + fields[:, 1]) % 7 - 3) * 0.7
        labels = (rng.random(batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        yield {
            "fields": torch.from_numpy(fields.astype(np.int32)).to(dev),
            "labels": torch.from_numpy(labels).to(dev),
        }


def gnn_full_batch(
    n_nodes: int,
    avg_degree: float,
    d_feat: int,
    n_classes: int,
    seed: int = 0,
    task: str = "node_class",
    n_out: int = 0,
    device="cuda",
) -> dict:
    """One full-graph batch from an R-MAT generator: the JAX package's batch
    bit for bit (the vertex count rounds up to a power of two), with the
    graph's arrays in its pull ordering (``dst`` ascending)."""
    dev = resolve_device(device)
    g = G.rmat(
        max(2, int(math.ceil(math.log2(max(n_nodes, 2))))),
        avg_degree=avg_degree,
        directed=False,
        seed=seed,
        device=dev,
    )
    rng = np.random.default_rng(seed)
    n = g.n_vertices
    batch = {
        "x": torch.from_numpy(rng.normal(size=(n, d_feat)).astype(np.float32)).to(dev),
        "src": g.src,
        "dst": g.dst,
        "emask": g.edge_mask,
    }
    if task == "regression":
        batch["labels"] = torch.from_numpy(
            rng.normal(size=(n, n_out)).astype(np.float32)
        ).to(dev)
        batch["lmask"] = torch.ones((n,), dtype=torch.float32, device=dev)
    else:
        batch["labels"] = torch.from_numpy(
            rng.integers(0, n_classes, size=n).astype(np.int32)
        ).to(dev)
        batch["lmask"] = torch.from_numpy(
            (rng.random(n) < 0.5).astype(np.float32)
        ).to(dev)
    return batch


def gnn_minibatches(
    graph,
    features: torch.Tensor,
    labels: torch.Tensor,
    batch_nodes: int,
    fanouts: Sequence[int],
    gen: torch.Generator,
) -> Iterator[dict]:
    """Sampled GraphSAGE minibatches from the neighbor sampler, on the
    graph's device: ``batch_nodes`` uniform seeds, then ``sample_khop``, all
    from ``gen``; the sentinel neighbor reads a zero feature row."""
    csr = CSR.from_graph(graph)
    n = graph.n_vertices
    dev = features.device
    feats_ext = torch.cat(
        [features, torch.zeros((1, features.shape[1]), dtype=features.dtype, device=dev)]
    )
    while True:
        seeds = torch.randint(0, n, (batch_nodes,), generator=gen, device=dev,
                              dtype=torch.int32)
        b0, b1 = sample_khop(csr, seeds, fanouts, gen)
        yield {
            "seed_x": gops.gather(feats_ext, seeds),
            "hop0_x": gops.gather(feats_ext, b0.neighbors.reshape(-1)),
            "hop0_mask": b0.mask,
            "hop1_x": gops.gather(feats_ext, b1.neighbors.reshape(-1)),
            "hop1_mask": b1.mask,
            "labels": gops.gather(labels, seeds),
        }
