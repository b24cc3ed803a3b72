from repro_torch.kernels.embedding_bag.ops import (
    embedding_bag,
    embedding_bag_plain,
)

__all__ = ["embedding_bag", "embedding_bag_plain"]
