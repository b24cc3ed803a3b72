"""AdamW with global-norm clipping and a configurable state dtype.

The JAX package's ``repro.optim.adamw`` on torch tensors. The update math
runs in float32 and each parameter keeps its dtype; ``state_dtype``
(``"bfloat16"``) stores the moments in that type. Where JAX returns new
parameters and state (and donates the old buffers to the step), the port
updates both in place under ``torch.no_grad()``: :func:`adamw_update_`.
The update stays a loop over the leaves, one fused f32 pass each, as the
JAX function's note explains (a map over layers raised its peak memory).

A parameter tree is any nesting of dicts, lists and ``nn.Module``s whose
leaves are tensors (``None`` is skipped); :func:`named_leaves` names each
leaf by its path, and the optimiser state is keyed by those names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: Optional[str] = None  # None → float32


def named_leaves(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` over a parameter tree, dict keys in sorted order
    (the JAX tree's order), list items by index, a module's parameters by
    their own names."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix or "/": tree}
    if isinstance(tree, nn.Module):
        return {f"{prefix}{name}": p for name, p in tree.named_parameters()}
    out: Dict[str, torch.Tensor] = {}
    items = (sorted(tree.items()) if isinstance(tree, Mapping)
             else enumerate(tree))
    for key, sub in items:
        out.update(named_leaves(sub, f"{prefix}{key}/"))
    return {k.rstrip("/"): v for k, v in out.items()}


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments beside every leaf of ``params`` (``state_dtype`` or
    float32) and an int32 step 0, on the parameters' device."""
    sdt = getattr(torch, cfg.state_dtype) if cfg.state_dtype else torch.float32
    leaves = named_leaves(params)
    dev = next(iter(leaves.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=sdt, device=p.device) for k, p in leaves.items()},
        "v": {k: torch.zeros(p.shape, dtype=sdt, device=p.device) for k, p in leaves.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def opt_state_from_arrays(convert: Callable[[Any], Any], state: Mapping[str, Any]):
    """The JAX package's AdamW state (each leaf a numpy array) as the
    port's: ``convert`` is the family's ``params_from_arrays`` (bound to
    its config and device), applied to the ``m`` and ``v`` trees."""
    m = {k: t.detach() for k, t in named_leaves(convert(state["m"])).items()}
    v = {k: t.detach() for k, t in named_leaves(convert(state["v"])).items()}
    dev = next(iter(m.values())).device
    step = torch.tensor(int(state["step"]), dtype=torch.int32, device=dev)
    return {"m": m, "v": v, "step": step}


def opt_state_tree(params, tree, state: Mapping[str, Any]) -> Dict[str, Any]:
    """``state`` in the JAX package's nesting (``adamw_init``'s tree):
    ``m`` and ``v`` in the structure of ``tree`` — ``params`` renested as
    the JAX tree over the same tensors (``params_tree``) — and ``step``.
    The leaves are ``state``'s own tensors, not copies."""
    name_of = {id(t): k for k, t in named_leaves(params).items()}

    def pick(moments, sub):
        if sub is None:
            return None
        if isinstance(sub, torch.Tensor):
            return moments[name_of[id(sub)]]
        if isinstance(sub, Mapping):
            return {k: pick(moments, v) for k, v in sub.items()}
        return [pick(moments, v) for v in sub]

    return {"m": pick(state["m"], tree), "v": pick(state["v"], tree), "step": state["step"]}


def global_norm(tensors) -> torch.Tensor:
    """√(Σ over the tensors of Σ x²), each squared in float32."""
    total = 0
    for x in tensors:
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update_(params, grads: Mapping[str, torch.Tensor], state, cfg: AdamWConfig,
                  lr_scale=1.0):
    """One AdamW step in place: ``params``' leaves and ``state``'s moments
    and step are overwritten. ``grads`` maps each leaf's name to its
    gradient. Math in float32, clipped by the global norm with
    ``min(1, clip / max(gn, 1e-9))``, bias corrections from the
    incremented int32 step; parameters keep their dtype. Returns ``state``."""
    leaves = named_leaves(params)
    step = state["step"] + 1
    scale = None  # each leaf's f32 gradient is made (and scaled) in the loop
    if cfg.clip_norm is not None:
        gn = global_norm(grads[k] for k in leaves)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=stepf.device)
    for k, p in leaves.items():
        g32, m, v = grads[k].float(), state["m"][k], state["v"][k]
        if scale is not None:
            g32 = g32 * scale
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + g32.square() * (1 - b2)
        del g32
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return state
