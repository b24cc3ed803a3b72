from repro_torch.data.pipeline import (
    gnn_full_batch,
    gnn_minibatches,
    recsys_batches,
    token_batches,
)

__all__ = ["gnn_full_batch", "gnn_minibatches", "recsys_batches", "token_batches"]
