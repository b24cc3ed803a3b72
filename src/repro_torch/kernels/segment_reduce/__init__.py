from repro_torch.kernels.segment_reduce.ops import (
    identity,
    segment_reduce,
    segment_reduce_bwd,
    segment_reduce_bwd_plain,
    segment_reduce_plain,
)

__all__ = [
    "identity",
    "segment_reduce",
    "segment_reduce_bwd",
    "segment_reduce_bwd_plain",
    "segment_reduce_plain",
]
