"""int8 gradient compression with error feedback (DP all-reduce shrinker).

The JAX package's ``repro.optim.grad_compress`` on torch tensors and
``torch.distributed``. int8 quantization cuts the gradient all-reduce's
traffic 4× against f32; error feedback keeps the quantization residual and
re-injects it the next step (EF-SGD).

* :func:`compress` / :func:`decompress` — per-tensor symmetric int8 with a
  max-abs scale (``torch.round`` rounds half to even, as ``jnp.round``);
* :func:`make_compressed_dp_grad_fn` — the data-parallel gradient with
  explicit collectives: per-rank gradients → error feedback and quantize
  against the scale all ranks agree on (``all_reduce`` MAX) → the int8
  values summed as int32 (``all_reduce`` SUM, exact) → the mean
  dequantized; the loss averaged over the ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import named_leaves


def _scale(x32: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x32.abs().max(), min=1e-30) / 127.0


def _quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g → (int8 q, f32 scale) with symmetric max-abs scaling."""
    g32 = g.float()
    scale = _scale(g32)
    return _quantize(g32, scale), scale


def decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_with_feedback(g, residual):
    """Error-feedback compression: returns (q, scale, new_residual)."""
    corrected = g.float() + residual
    q, scale = compress(corrected)
    return q, scale, corrected - decompress(q, scale)


def make_compressed_dp_grad_fn(loss_fn: Callable, mesh, data_axis: str = "data"):
    """Data-parallel gradient with int8-over-the-wire all-reduce.

    Returns ``grad_fn(params, batch, residuals) -> (loss, grads,
    residuals)``: ``params`` replicated on every rank, ``batch`` this
    rank's shard of the batch, ``residuals`` an f32 ``{leaf name:
    tensor}`` per parameter (``optim.named_leaves``; zeros at first). Each
    rank returns the same mean gradients and loss. On a one-rank mesh no
    collective runs.
    """
    from repro_torch.launch.train import value_and_grad

    group = (None if mesh.device_mesh is None
             else mesh.device_mesh.get_group(data_axis))
    n = 1 if group is None else dist.get_world_size(group)

    def reduce_leaf(gl: torch.Tensor, res: torch.Tensor):
        corrected = gl.float() + res
        # all ranks quantize against the SAME scale before the integer sum
        scale = _scale(corrected)
        if group is not None:
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _quantize(corrected, scale)
        new_res = corrected - q.float() * scale
        total = q.to(torch.int32)
        if group is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = total.float() * scale / n
        return mean.to(gl.dtype), new_res

    def grad_fn(params, batch, residuals: Dict[str, torch.Tensor]):
        loss, g = value_and_grad(loss_fn, params, batch)
        grads, new_res = {}, {}
        for k in named_leaves(params):
            grads[k], new_res[k] = reduce_leaf(g[k], residuals[k])
        loss = loss.float()
        if group is not None:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return loss / n, grads, new_res

    return grad_fn
