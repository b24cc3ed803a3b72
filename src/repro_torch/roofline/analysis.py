"""Roofline terms of a dry-run step, for one NVIDIA H100 SXM5 per rank.

The JAX package's ``repro.roofline.analysis`` on the port. The hardware
model :class:`HW` is the H100 SXM5 datasheet's (dense bf16 989 TFLOP/s,
HBM3 3.35 TB/s, NVLink 450 GB/s a direction, 80 GB), except that
:meth:`HW.from_card` reads the card's own memory size from
``torch.cuda.get_device_properties``. Terms, in seconds a step:

    compute    = flops_per_device / peak_flops
    memory     = hbm_bytes_per_device / hbm_bw
    collective = collective_bytes_per_device / link_bw

:func:`roofline_terms` keeps the JAX function's formula and keys. JAX
reads a step's collectives from the partitioned HLO; the port has no HLO,
so :func:`collective_bytes_from_counts` charges the same ring formulas
(:func:`ring_bytes`) to the per-kind bytes that ``dist.collectives.COUNTS``
records as the step runs, each call over its own group (a gather over the
data axis of a 16 × 16 mesh rings over 16 ranks, not 256):

    all-gather       ≈ output_bytes × (n-1)/n
    reduce-scatter   ≈ input_bytes  × (n-1)/n
    all-reduce       ≈ 2 × input_bytes × (n-1)/n
    all-to-all       ≈ input_bytes  × (n-1)/n
    collective-permute ≈ input_bytes
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch


@dataclasses.dataclass(frozen=True)
class HW:
    """One H100 SXM5, datasheet values: dense bf16 tensor-core peak, HBM3
    bandwidth, NVLink bandwidth a direction, HBM capacity."""

    peak_flops: float = 989e12  # bf16 dense / card
    hbm_bw: float = 3.35e12  # bytes/s
    link_bw: float = 450e9  # bytes/s a direction (NVLink 4)
    hbm_bytes: float = 80e9  # capacity

    @classmethod
    def from_card(cls, device: int = 0) -> "HW":
        """The datasheet's rates with the card's own memory size."""
        return cls(hbm_bytes=float(torch.cuda.get_device_properties(device).total_memory))


COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: ``dist.collectives.COUNTS`` names → the kinds above
COUNTED = {"all_gather": "all-gather", "all_reduce": "all-reduce",
           "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def ring_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Per-device wire bytes of one collective whose *output* has
    ``out_bytes`` over ``n`` devices (JAX's convention: the HLO's result
    shape), by the ring formulas of the module docstring."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)  # input = out × n
    if kind == "all-to-all":
        return out_bytes * frac
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(kind)


def collective_bytes_from_counts(counts: Mapping[str, int], n_devices: int
                                 ) -> Dict[str, float]:
    """Per-device wire bytes per collective kind from ``COUNTS``: the
    wire bytes each call recorded over its own group (``<name>_wire_bytes``)
    where there are any, else each call's *input* bytes (``<name>_bytes``)
    charged over ``n_devices``: an all-gather's output is n × its input, a
    reduce-scatter's its input / n."""
    n = n_devices
    per_kind = {k: 0.0 for k in COLLECTIVE_OPS}
    for name, kind in COUNTED.items():
        if f"{name}_wire_bytes" in counts:
            per_kind[kind] += float(counts[f"{name}_wire_bytes"])
            continue
        nbytes = float(counts.get(f"{name}_bytes", 0))
        out = {"all-gather": nbytes * n, "reduce-scatter": nbytes / max(n, 1)}.get(kind, nbytes)
        per_kind[kind] += ring_bytes(kind, out, n)
    per_kind["total"] = sum(per_kind.values())
    return per_kind


def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
    n_devices: int,
    hw: Optional[HW] = None,
    model_flops: Optional[float] = None,
) -> Dict[str, float]:
    hw = hw or HW()
    compute = flops_per_device / hw.peak_flops
    memory = hbm_bytes_per_device / hw.hbm_bw
    collective = collective_bytes_per_device / hw.link_bw
    terms = {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "bottleneck": max(
            ("compute_s", compute),
            ("memory_s", memory),
            ("collective_s", collective),
            key=lambda kv: kv[1],
        )[0],
        "step_lower_bound_s": max(compute, memory, collective),
    }
    if model_flops is not None:
        total = flops_per_device * n_devices
        terms["model_flops"] = model_flops
        terms["useful_flops_ratio"] = model_flops / total if total else 0.0
        # roofline fraction: useful model flops per second vs peak
        denom = terms["step_lower_bound_s"] * n_devices * hw.peak_flops
        terms["roofline_fraction"] = model_flops / denom if denom else 0.0
    return terms
