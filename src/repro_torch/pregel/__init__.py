"""Pregel BSP runtime on torch: superstep-by-superstep execution of
compiled Palgol with a host-side barrier (and fixed-point check) between
supersteps. Counterpart of ``repro.pregel``."""

from repro_torch.pregel.runtime import run_bsp, BSPResult

__all__ = ["run_bsp", "BSPResult"]
