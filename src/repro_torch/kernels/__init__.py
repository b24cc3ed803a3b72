"""Hand-written CUDA kernels for Hopper, one per TPU kernel ported so far.

Each kernel package has one ``ops.py`` with three parts:
  the wrapper     — checks device, dtype, shape and contiguity, launches the
                    CUDA kernel of ``repro_torch/csrc`` on the current
                    stream and counts its launches (``<wrapper>.launches``);
  the plain version — the same function in plain PyTorch, which the wrapper
                    takes only for tensors on the CPU or the meta device;
  the fake route  — for the dry-run's fake tensors: the output's shape and
                    dtype, the launch counted, its bound work recorded
                    (``kernels.fake``), nothing built;
  a source note   — in the ``.cu`` file: the TPU kernel it replaces, its
                    bound on the card and what its design does about it.

Kernels (``build.KERNELS``):
  gather_rows     — row gather, the Palgol remote read (replaces
                    ``repro/kernels/gather_rows``);
  segment_reduce  — sorted segmented reduction with the six Palgol
                    combiners, the message combiner (replaces
                    ``repro/kernels/segment_reduce``);
  flash_attention — forward online-softmax attention (GQA, causal,
                    window), the LM's prefill attention (replaces
                    ``repro/kernels/flash_attention``);
  embedding_bag   — fixed-width weighted bag sums, AutoInt's lookup
                    (replaces ``repro/kernels/embedding_bag``);
  flash_attention_bwd — the flash forward's backward (in
                    ``kernels/flash_attention``);
  scatter_rows    — a deterministic reduce-by-key over sorted ids, the
                    table gradient of ``gather_rows`` and ``embedding_bag``;
  segment_reduce_bwd — ``segment_reduce``'s values gradient from its
                    offsets (in ``kernels/segment_reduce``).
"""

from repro_torch.kernels.embedding_bag.ops import (
    embedding_bag,
    embedding_bag_plain,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.gather_rows.ops import gather_rows, gather_rows_plain
from repro_torch.kernels.scatter_rows.ops import scatter_rows, scatter_rows_plain
from repro_torch.kernels.segment_reduce.ops import (
    segment_reduce,
    segment_reduce_bwd,
    segment_reduce_bwd_plain,
    segment_reduce_plain,
)

__all__ = [
    "embedding_bag",
    "embedding_bag_plain",
    "flash_attention",
    "flash_attention_plain",
    "gather_rows",
    "gather_rows_plain",
    "scatter_rows",
    "scatter_rows_plain",
    "segment_reduce",
    "segment_reduce_bwd",
    "segment_reduce_bwd_plain",
    "segment_reduce_plain",
]
