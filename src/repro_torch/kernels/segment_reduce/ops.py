"""Segmented reduction: the CUDA kernel ``csrc/segment_reduce.cu`` and its
plain version.

``segment_reduce(values, segment_ids, num_segments, op, mask, offsets)``
reduces the rows of ``values [E, ...]`` by their segment with the Palgol
combiner ``op`` (sum, prod, min, max, or, and). Ids outside
``[0, num_segments)`` belong to no segment and are dropped. The kernel
needs the ids ascending and reads only their CSR offsets ``[n + 1]`` (rows
``offsets[s]:offsets[s+1]`` have id ``s``), which a graph computes once;
the plain version scatters by the ids and ignores the offsets.
Masked rows contribute the identity; an empty segment gets the identity
(:func:`identity`). Float sums and products accumulate in float32 and
return the input dtype; int32 sums wrap.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version is taken only for tensors on the CPU or the meta device.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

OPS = ("sum", "prod", "min", "max", "or", "and")
_OP_CODE = {op: i for i, op in enumerate(OPS)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2, torch.bool: 3}
#: the combiners the kernel takes for each element type
_KERNEL_OPS = {
    torch.float32: ("sum", "prod", "min", "max"),
    torch.bfloat16: ("sum", "prod", "min", "max"),
    torch.int32: ("sum", "prod", "min", "max"),
    torch.bool: ("min", "max", "or", "and"),
}
_SCATTER_REDUCE = {
    "sum": "sum", "prod": "prod", "min": "amin", "max": "amax",
    "or": "amax", "and": "amin",
}


def identity(op: str, dtype: torch.dtype):
    """The combiner's identity in ``dtype`` as a Python scalar — the JAX
    package's ``graph.ops._identity_for`` table, and what an empty segment
    reduces to."""
    if dtype == torch.bool:
        return {"and": True, "or": False, "sum": False, "max": False, "min": True}[op]
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return {"sum": 0, "min": info.max, "max": info.min, "prod": 1}[op]
    return {
        "sum": 0.0, "min": math.inf, "max": -math.inf, "prod": 1.0,
        "and": 1.0, "or": 0.0,
    }[op]


def segment_reduce_plain(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str,
    mask=None,
    offsets=None,
):
    """The plain PyTorch version: ``scatter_reduce`` with
    ``include_self=True`` into an identity-filled buffer with one extra
    sentinel row that takes every dropped id."""
    n = num_segments
    if values.dtype == torch.bool:
        if op not in _KERNEL_OPS[torch.bool]:
            raise TypeError(f"combiner {op!r} does not take bool values")
        work = values.to(torch.uint8)
    elif op in ("or", "and"):
        raise TypeError(f"combiner {op!r} takes bool values, got {values.dtype}")
    elif values.dtype in (torch.float16, torch.bfloat16):
        work = values.float()
    else:
        work = values
    ident = identity(op, values.dtype)
    if mask is not None:
        mshape = mask.shape + (1,) * (values.ndim - 1)
        work = torch.where(mask.reshape(mshape), work, ident)
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    index = ids.reshape(ids.shape + (1,) * (values.ndim - 1)).expand(work.shape)
    buf = torch.full(
        (n + 1,) + values.shape[1:], ident, dtype=work.dtype, device=values.device
    )
    buf.scatter_reduce_(0, index, work, _SCATTER_REDUCE[op], include_self=True)
    return buf[:n].to(values.dtype)


@functools.cache
def _entry():
    """The C entry point of the kernel's library, typed."""
    fn = build.library("segment_reduce").segment_reduce_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(values, mask, offsets, out, op):
    fn = _entry()
    rc = fn(
        values.device.index or 0,
        values.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        offsets.data_ptr(),
        out.data_ptr(),
        offsets.shape[0] - 1,
        out[0].numel() if out.shape[0] else 0,
        _DTYPE_CODE[values.dtype],
        _OP_CODE[op],
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segment_reduce kernel launch failed: CUDA error {rc}")


def segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str,
    mask=None,
    offsets=None,
):
    """Segment reduction on the card by ``csrc/segment_reduce.cu``; see
    module. On the card ``segment_ids`` is not read: ``offsets`` carry the
    segmentation and must agree with the ids."""
    if values.device.type != "cuda":
        return segment_reduce_plain(
            values, segment_ids, num_segments, op, mask, offsets
        )
    if op not in OPS:
        raise ValueError(f"unknown combiner {op!r}")
    if values.dtype not in _KERNEL_OPS or op not in _KERNEL_OPS[values.dtype]:
        raise TypeError(f"segment_reduce kernel does not take {op!r} on {values.dtype}")
    if offsets is None or offsets.dtype != torch.int32 or tuple(offsets.shape) != (
        num_segments + 1,
    ):
        raise TypeError(f"offsets must be int32 [{num_segments + 1}] on the card")
    if values.ndim < 1:
        raise TypeError("values must be [E, ...]")
    for name, t in (("offsets", offsets), ("mask", mask)):
        if t is not None and t.device != values.device:
            raise ValueError(f"{name} on {t.device}, values on {values.device}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != values.shape[:1]):
        raise TypeError("mask must be bool [E]")
    if not (
        values.is_contiguous()
        and offsets.is_contiguous()
        and (mask is None or mask.is_contiguous())
    ):
        raise ValueError("segment_reduce needs contiguous values, offsets and mask")
    out = torch.empty((num_segments,) + values.shape[1:], dtype=values.dtype, device=values.device)
    if out.numel() == 0:
        return out
    _launch(values, mask, offsets, out, op)
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
