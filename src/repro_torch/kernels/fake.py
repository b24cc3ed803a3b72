"""The kernels' fake route: what a wrapper does for the dry-run's tensors.

``launch.dryrun`` traces a step under ``FakeTensorMode``: its tensors
(``FakeTensor``) carry a shape, a dtype and a device but no memory and no
values. Every kernel wrapper takes this route for a fake tensor, whatever
device it names (the dry-run traces the card's route; on a host without
CUDA, PyTorch's autograd cannot hold fake CUDA tensors, so there the
tensors name the CPU): it runs the wrapper's own checks, returns an output
of the kernel's shape and dtype (``torch.empty`` under the fake mode, which
allocates nothing), bumps the wrapper's ``launches*`` counters by the same
route rule as a launch, and adds the kernel's bound work to :data:`WORK`
by ``PERF.md``'s bound formulas: the bytes of each input read once and
each output written once, the rows of a ``scalar`` gather or a bag counted
once per distinct row (a fake index has no values, so at most
``min(ids, rows)``), and flash attention's kept pairs × 4·D flops (× 10·D
for the backward). Nothing is built and no library is loaded.

A real tensor never takes this route: a CUDA tensor launches its kernel or
raises, a CPU or meta tensor takes the plain version.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

#: kernel → {"launches", "bytes", "flops"}, summed over the fake launches
#: since :func:`reset`
WORK: Dict[str, Dict[str, float]] = {}


def is_fake(t: Optional[torch.Tensor]) -> bool:
    """Whether ``t`` is a dry-run tensor (a ``FakeTensor``)."""
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """Whether the card's route takes ``t``: a CUDA tensor, or a fake one."""
    return t.device.type == "cuda" or is_fake(t)


def reset() -> None:
    WORK.clear()


def record(kernel: str, nbytes: float, flops: float = 0.0) -> None:
    """One fake launch of ``kernel`` doing ``nbytes`` of traffic and
    ``flops`` operations at its bound."""
    w = WORK.setdefault(kernel, {"launches": 0, "bytes": 0.0, "flops": 0.0})
    w["launches"] += 1
    w["bytes"] += float(nbytes)
    w["flops"] += float(flops)


def nbytes(*tensors) -> int:
    """The bytes of the given tensors (``None`` counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def distinct_rows(n_ids: int, n_rows: int) -> int:
    """The most distinct rows ``n_ids`` ids can name in a table of
    ``n_rows``: the bound's distinct rows when the ids have no values."""
    return min(int(n_ids), int(n_rows))


def kept_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (query, key) pairs one head keeps: key ``j`` for query ``i`` iff
    ``j <= i`` under ``causal`` and ``i - j < window`` under a window."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(i - int(window) + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())
