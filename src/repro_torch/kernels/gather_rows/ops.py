"""Row gather: the CUDA kernel ``csrc/gather_rows.cu`` and its plain version.

``gather_rows(table, idx, fill=None)`` computes ``out[i] = table[j(i)]`` for
a table ``[V, ...]`` of 1-, 2- or 4-byte elements and int32 indices ``[N]``:

* ``fill=None`` clips (``j = clamp(idx, 0, V-1)``), as the TPU kernel
  ``repro/kernels/gather_rows`` and ``jnp.take(mode="clip")`` do;
* with a ``fill`` scalar, an index in ``[-V, -1]`` wraps to ``idx + V`` and
  any other index outside ``[0, V)`` reads ``fill``, as
  ``jnp.take(mode="fill")`` does.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version is taken only for tensors on the CPU or the meta device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor, fill=None):
    """The plain PyTorch version: ``index_select`` with the index modes
    handled explicitly."""
    v = table.shape[0]
    j = idx.reshape(-1).long()
    if fill is None:
        out = table.index_select(0, j.clamp(0, max(v - 1, 0)))
    else:
        j = torch.where(j < 0, j + v, j)
        ok = (j >= 0) & (j < v)
        out = table.index_select(0, torch.where(ok, j, 0))
        ok = ok.reshape(ok.shape + (1,) * (table.ndim - 1))
        out = torch.where(ok, out, _fill_scalar(fill, table.dtype))
    return out.reshape(idx.shape + table.shape[1:])


def _fill_scalar(fill, dtype):
    """``fill`` cast to ``dtype`` as a Python scalar (the JAX package casts
    its static fill value the same way)."""
    return torch.tensor(fill).to(dtype).item()


def _fill_bits(fill, dtype) -> int:
    """The raw bits of ``fill`` in ``dtype``, as the kernel's uint32."""
    if fill is None:
        return 0
    raw = torch.tensor([fill]).to(dtype).view(torch.uint8).tolist()
    return int.from_bytes(bytes(raw), "little")


@functools.cache
def _entry():
    """The C entry point of the kernel's library, typed."""
    fn = build.library("gather_rows").gather_rows_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(table, idx, out, mode, fill_bits):
    fn = _entry()
    rc = fn(
        table.device.index or 0,
        table.data_ptr(),
        idx.data_ptr(),
        out.data_ptr(),
        table.shape[0],
        idx.shape[0],
        out[0].numel() if out.shape[0] else 0,
        table.element_size(),
        mode,
        fill_bits,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {rc}")


def gather_rows(table: torch.Tensor, idx: torch.Tensor, fill=None):
    """``table[idx]`` on the card by ``csrc/gather_rows.cu``; see module."""
    if table.device.type != "cuda":
        return gather_rows_plain(table, idx, fill)
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise TypeError(f"idx must be int32 [N], got {idx.dtype} {tuple(idx.shape)}")
    if table.ndim < 1 or table.element_size() not in (1, 2, 4):
        raise TypeError(
            f"table must be [V, ...] of 1-, 2- or 4-byte elements, got "
            f"{table.dtype} {tuple(table.shape)}"
        )
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows needs contiguous table and idx")
    if table.shape[0] == 0 and fill is None:
        raise ValueError("clip-mode gather from an empty table")
    out = torch.empty(
        (idx.shape[0],) + table.shape[1:], dtype=table.dtype, device=table.device
    )
    if out.numel() == 0:
        return out
    _launch(table, idx, out, 0 if fill is None else 1, _fill_bits(fill, table.dtype))
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
