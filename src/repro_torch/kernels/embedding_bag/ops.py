"""Embedding bags: the CUDA kernel ``csrc/embedding_bag.cu`` and its plain
version.

``embedding_bag(table, indices, weights=None, mask=None)`` mirrors the JAX
wrapper ``repro.kernels.embedding_bag.ops.embedding_bag_pallas``: for a
table ``[V, D]`` (float32 or bfloat16) and bags ``indices [B, H]`` (int32)
it returns ``out[b] = Σ_h w[b, h] · table[idx[b, h]]`` ``[B, D]``, summed
in float32 and returned in the table's dtype. ``weights`` default to 1;
``mask`` is folded into them (``weights * mask`` in the weights' dtype),
and the weights are then cast to the table's dtype. An index is clipped to
``[0, V-1]``, as the JAX package's ``ref.py`` and its model callers read.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version is taken only for tensors on the CPU or the meta device, and the
dry-run's fake tensors take the fake route (``kernels.fake``). The
kernel has two routes, which its C entry chooses and reports (:func:`route`
is its rule): ``vec``
(bags of one slot of rows a multiple of 16 bytes long, from a 16-byte
aligned table, in 16-byte chunks; AutoInt's lookup) and ``scalar`` (one
thread per output element, every other bag), counted in
``embedding_bag.launches_vec`` and ``embedding_bag.launches_scalar`` beside
``embedding_bag.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, fake

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def bag_weights(table, indices, weights=None, mask=None):
    """The per-slot weights in the table's dtype, or ``None`` for all ones
    — ``embedding_bag_pallas``'s defaulting and mask folding."""
    if weights is None and mask is None:
        return None
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype, device=table.device)
    if mask is not None:
        weights = weights * mask.to(weights.dtype)
    return weights.to(table.dtype)


def embedding_bag_plain(table, indices, weights=None, mask=None):
    """The plain PyTorch version: clipped ``index_select``, f32 weighted sum."""
    v, d = table.shape
    w = bag_weights(table, indices, weights, mask)
    rows = table.index_select(0, indices.reshape(-1).long().clamp(0, v - 1))
    rows = rows.reshape(indices.shape + (d,)).float()
    if w is not None:
        rows = rows * w.float()[..., None]
    return rows.sum(dim=1).to(table.dtype)


def route(n_hot: int, d: int, dtype: torch.dtype, table_address: int) -> str:
    """The C entry's route rule (``route`` in csrc/embedding_bag.cu): ``"vec"``
    for one-slot bags of rows a multiple of 16 bytes from a 16-byte aligned
    table, else ``"scalar"``."""
    row_bytes = d * dtype.itemsize
    return "vec" if n_hot == 1 and row_bytes % 16 == 0 and table_address % 16 == 0 else "scalar"


@functools.cache
def _entry():
    """The C entry point of the kernel's library, typed."""
    fn = build.library("embedding_bag").embedding_bag_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
    ]
    fn.restype = ctypes.c_int
    return fn


def embedding_bag(table, indices, weights=None, mask=None):
    """Bag sums on the card by ``csrc/embedding_bag.cu``; see module."""
    if not fake.on_card(table):
        return embedding_bag_plain(table, indices, weights, mask)
    if table.ndim != 2 or table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table must be float32/bfloat16 [V, D], got "
                        f"{table.dtype} {tuple(table.shape)}")
    if indices.dtype != torch.int32 or indices.ndim != 2:
        raise TypeError(f"indices must be int32 [B, H], got "
                        f"{indices.dtype} {tuple(indices.shape)}")
    for name, t in (("weights", weights), ("mask", mask)):
        if t is not None and t.shape != indices.shape:
            raise TypeError(f"{name} {tuple(t.shape)} differs from indices "
                            f"{tuple(indices.shape)}")
    for name, t in (("indices", indices), ("weights", weights), ("mask", mask)):
        if t is not None and t.device != table.device:
            raise ValueError(f"{name} on {t.device}, table on {table.device}")
    if table.shape[0] == 0:
        raise ValueError("embedding_bag from an empty table")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("embedding_bag needs a contiguous table and indices")
    w = bag_weights(table, indices, weights, mask)
    if w is not None:
        w = w.contiguous()
    b, h = indices.shape
    out = torch.empty((b, table.shape[1]), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if fake.is_fake(table):  # the allocation is aligned; a view adds its offset
        took = route(h, table.shape[1], table.dtype,
                     table.storage_offset() * table.element_size())
        rows = fake.distinct_rows(b * h, table.shape[0])
        fake.record("embedding_bag", rows * table.shape[1] * table.element_size()
                    + fake.nbytes(indices, w, out))
        return _count(took, out)
    took = ctypes.c_int(-1)
    rc = _entry()(
        table.device.index or 0, table.data_ptr(), indices.data_ptr(),
        None if w is None else w.data_ptr(), out.data_ptr(), table.shape[0],
        b, h, table.shape[1], _DTYPE_CODE[table.dtype],
        torch.cuda.current_stream(table.device).cuda_stream, ctypes.byref(took),
    )
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {rc}")
    return _count("vec" if took.value == 0 else "scalar", out)


def _count(took: str, out):
    embedding_bag.launches += 1
    if took == "vec":
        embedding_bag.launches_vec += 1
    else:
        embedding_bag.launches_scalar += 1
    return out


embedding_bag.launches = 0
embedding_bag.launches_vec = 0
embedding_bag.launches_scalar = 0
