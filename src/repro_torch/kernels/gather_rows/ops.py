"""Row gather: the CUDA kernel ``csrc/gather_rows.cu`` and its plain version.

``gather_rows(table, idx, fill=None)`` computes ``out[i] = table[j(i)]`` for
a table ``[V, ...]`` of 1-, 2- or 4-byte elements and int32 indices ``[N]``:

* ``fill=None`` clips (``j = clamp(idx, 0, V-1)``), as the TPU kernel
  ``repro/kernels/gather_rows`` and ``jnp.take(mode="clip")`` do;
* with a ``fill`` scalar, an index in ``[-V, -1]`` wraps to ``idx + V`` and
  any other index outside ``[0, V)`` reads ``fill``, as
  ``jnp.take(mode="fill")`` does.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version is taken only for tensors on the CPU or the meta device, and the
dry-run's fake tensors take the fake route (``kernels.fake``). The
kernel has two routes, chosen by row length alone (:func:`route`):
``"vec"`` (rows of one element, a warp over 32 neighbouring outputs) and
``"scalar"`` (wider rows, a group of lanes a row, copied in the widest
access of 16, 8, 4, 2 or 1 bytes that the row's bytes and both base
addresses allow: :func:`access_bytes`), counted in
``gather_rows.launches_vec`` and ``gather_rows.launches_scalar`` beside
``gather_rows.launches``. The C entry reports the access width it took;
the wrapper keeps the last one in ``gather_rows.last_access_bytes``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build, fake


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


def _fill_value(fill, dtype) -> torch.Tensor:
    """``fill`` as a 0-d tensor of ``dtype``, cast as the JAX package casts
    its static fill value (``np.asarray(fill, dtype)``): into an integer or
    bool table numpy converts it, so a value the dtype cannot hold raises
    ``OverflowError`` (inf, 3e9) or ``ValueError`` (NaN) as it does there."""
    if dtype.is_floating_point:
        return torch.tensor(fill).to(dtype)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(np.array(np.asarray(fill, np_dtype)))


def _fill_scalar(fill, dtype):
    """``fill`` cast to ``dtype`` as a Python scalar."""
    return _fill_value(fill, dtype).item()


def _fill_bits(fill, dtype) -> int:
    """The raw bits of ``fill`` in ``dtype``, as the kernel's uint32."""
    if fill is None:
        return 0
    raw = _fill_value(fill, dtype).reshape(1).view(torch.uint8).tolist()
    return int.from_bytes(bytes(raw), "little")


def route(row_len: int) -> str:
    """The kernel's route for rows of ``row_len`` elements: ``"vec"`` for
    one element, else ``"scalar"`` (the C entry's rule)."""
    return "vec" if row_len == 1 else "scalar"


#: the scalar route's access widths, widest first
ACCESS_BYTES = (16, 8, 4, 2, 1)


def access_bytes(row_bytes: int, table_ptr: int, out_ptr: int) -> int:
    """The bytes of one access of the scalar route (the C entry's rule):
    the widest of :data:`ACCESS_BYTES` that divides the row's bytes and
    both base addresses."""
    return next(a for a in ACCESS_BYTES
                if row_bytes % a == 0 and table_ptr % a == 0 and out_ptr % a == 0)


@functools.cache
def _entry():
    """The C entry point of the kernel's library, typed."""
    fn = build.library("gather_rows").gather_rows_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(table, idx, out, row_len, mode, fill_bits):
    """Launches the kernel; returns the access width the C entry took."""
    took = ctypes.c_int(0)
    rc = _entry()(
        table.device.index or 0,
        table.data_ptr(),
        idx.data_ptr(),
        out.data_ptr(),
        table.shape[0],
        idx.shape[0],
        row_len,
        table.element_size(),
        mode,
        fill_bits,
        torch.cuda.current_stream(table.device).cuda_stream,
        ctypes.byref(took),
    )
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {rc}")
    return took.value


def gather_rows(table: torch.Tensor, idx: torch.Tensor, fill=None):
    """``table[idx]`` on the card by ``csrc/gather_rows.cu``; see module."""
    if not fake.on_card(table):
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
    row_len = math.prod(table.shape[1:])
    if fake.is_fake(table):
        rows = table.shape[0] if route(row_len) == "vec" else fake.distinct_rows(
            idx.shape[0], table.shape[0])
        fake.record("gather_rows",
                    rows * row_len * table.element_size() + fake.nbytes(idx, out))
    else:
        gather_rows.last_access_bytes = _launch(
            table, idx, out, row_len, 0 if fill is None else 1, _fill_bits(fill, table.dtype))
    gather_rows.launches += 1
    if route(row_len) == "vec":
        gather_rows.launches_vec += 1
    else:
        gather_rows.launches_scalar += 1
    return out


gather_rows.launches = 0
gather_rows.launches_vec = 0
gather_rows.launches_scalar = 0
gather_rows.last_access_bytes = None
