"""Synthetic data pipelines (deterministic, numpy-seeded).

The port's half of ``repro.data.pipeline`` so far: the recsys generator,
with the JAX package's numpy draws, so that one seed gives the same batches
in both packages; each batch is returned as tensors on ``device``. The LM
and GNN generators come with their slices.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.graph.structure import resolve_device


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
