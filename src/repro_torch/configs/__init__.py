"""Architecture registry: ``get_spec(arch_id)`` / ``all_arch_ids()``.

The JAX package's registry (``repro.configs``), all ten of its ids: the
dense LMs (``h2o-danube-1.8b``, ``qwen3-32b``, ``qwen2.5-32b``), the MoE
LMs (``deepseek-moe-16b``, ``qwen3-moe-235b-a22b``), the four GNNs
(forward) and AutoInt. Each config module is a copy of the JAX package's,
differing only in the package name. ``resolve_gnn_config`` binds the
shape-dependent dims (d_feat, n_classes) that GNN configs leave open.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.common import ArchSpec, GNN_SHAPE_CLASSES

_MODULES = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "pna": "repro_torch.configs.pna",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "graphcast": "repro_torch.configs.graphcast",
    "gat-cora": "repro_torch.configs.gat_cora",
    "autoint": "repro_torch.configs.autoint",
}


def all_arch_ids() -> List[str]:
    """Every architecture id of the registry."""
    return list(_MODULES)


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).spec()


def resolve_gnn_config(cfg, shape_id: str, shape: Dict):
    """Bind shape-dependent dims (d_in from d_feat, n_out from the dataset's
    class count) into a GNN config."""
    d_in = shape.get("d_feat", cfg.d_in)
    updates = {"d_in": d_in}
    if cfg.n_out < 0:
        updates["n_out"] = GNN_SHAPE_CLASSES.get(shape_id, 16)
    if shape.get("kind") == "batched_graphs" and cfg.task == "node_class":
        updates["task"] = "graph_class"
    return dataclasses.replace(cfg, **updates)
