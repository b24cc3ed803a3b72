"""Architecture registry: ``get_spec(arch_id)`` / ``all_arch_ids()``.

The JAX package's registry (``repro.configs``) over the architectures the
port runs so far: the dense LMs (``h2o-danube-1.8b``, ``qwen3-32b``,
``qwen2.5-32b``) and AutoInt. Each config module is a copy of the JAX
package's, differing only in the package name. The MoE LMs and the GNNs
are known ids whose models are not ported yet: asking for them raises
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.common import ArchSpec

_MODULES = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "autoint": "repro_torch.configs.autoint",
}

#: ids of the JAX registry whose models the port does not run yet
_NOT_PORTED = {
    "qwen3-moe-235b-a22b": "the MoE transformer (ROADMAP A7)",
    "deepseek-moe-16b": "the MoE transformer (ROADMAP A7)",
    "pna": "the GNN models (ROADMAP A5)",
    "graphsage-reddit": "the GNN models (ROADMAP A5)",
    "graphcast": "the GNN models (ROADMAP A5)",
    "gat-cora": "the GNN models (ROADMAP A5)",
}


def all_arch_ids() -> List[str]:
    """The ids the port runs."""
    return list(_MODULES)


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} needs {_NOT_PORTED[arch_id]}, not ported yet"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).spec()
