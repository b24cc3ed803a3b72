"""Hand-written CUDA kernels for Hopper, one per TPU kernel ported so far.

Each kernel package has one ``ops.py`` with three parts:
  the wrapper     — checks device, dtype, shape and contiguity, launches the
                    CUDA kernel of ``repro_torch/csrc`` on the current
                    stream and counts its launches (``<wrapper>.launches``);
  the plain version — the same function in plain PyTorch, which the wrapper
                    takes only for tensors on the CPU or the meta device;
  a source note   — in the ``.cu`` file: the TPU kernel it replaces, its
                    bound on the card and what its design does about it.

Kernels (``build.KERNELS``):
  gather_rows     — row gather, the Palgol remote read (replaces
                    ``repro/kernels/gather_rows``);
  segment_reduce  — sorted segmented reduction with the six Palgol
                    combiners, the message combiner (replaces
                    ``repro/kernels/segment_reduce``).
"""

from repro_torch.kernels.gather_rows.ops import gather_rows, gather_rows_plain
from repro_torch.kernels.segment_reduce.ops import (
    segment_reduce,
    segment_reduce_plain,
)

__all__ = [
    "gather_rows",
    "gather_rows_plain",
    "segment_reduce",
    "segment_reduce_plain",
]
