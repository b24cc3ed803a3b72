"""Deterministic reduce-by-key: the CUDA kernel ``csrc/scatter_rows.cu`` and
its plain version.

``scatter_rows(sorted_rows, perm, values, num_rows, w=None, h=1)`` takes
int32 ids sorted stably and the sort's int64 permutation (as
``torch.sort(ids, stable=True)`` returns them) and computes

    out[r] = Σ w[perm[j]] · values[perm[j] // h]   over j with sorted_rows[j] == r

``[num_rows, ...]``, in ascending ``j``: the table gradient of a row gather
(``values`` the output's cotangent, ``h = 1``, no weights) and of an
embedding bag (``values`` the bags' cotangent, ``h`` slots a bag, ``w`` the
folded per-slot weights in ``values``' dtype). Ids outside ``[0,
num_rows)`` are dropped; a row that no id names is 0. f32 and bf16 sum in
f32 and round once.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version is taken only for tensors on the CPU or the meta device, and the
dry-run's fake tensors take the fake route (``kernels.fake``). The C
entry plans the launch (:func:`plan`: the access width, 16 bytes where the
row and both base addresses allow it, and the positions a tile), the
wrapper sizes the scratch by that plan, and the launch is counted in
``scatter_rows.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, fake

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def scatter_rows_plain(sorted_rows, perm, values, num_rows: int, w=None, h: int = 1):
    """The plain PyTorch version: a sequential f32 ``index_add_`` over the
    sorted order, rounded once."""
    perm = perm.reshape(-1).long()
    src = perm if h <= 1 else torch.div(perm, h, rounding_mode="floor")
    rows = values.reshape(values.shape[0], math.prod(values.shape[1:])).float()
    rows = rows.index_select(0, src)
    if w is not None:
        rows = rows * w.reshape(-1).float().index_select(0, perm)[:, None]
    ids = sorted_rows.reshape(-1).long()
    ok = (ids >= 0) & (ids < num_rows)
    out = torch.zeros((num_rows, rows.shape[1]), dtype=torch.float32, device=values.device)
    out.index_add_(0, ids[ok], rows[ok])
    return out.to(values.dtype).reshape((num_rows,) + tuple(values.shape[1:]))


@functools.cache
def _lib():
    """The kernel's library with its C entry points typed."""
    lib = build.library("scatter_rows")
    lib.scatter_rows_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.scatter_rows_plan.restype = ctypes.c_int
    lib.scatter_rows_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.scatter_rows_scratch_bytes.restype = ctypes.c_longlong
    lib.scatter_rows_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.scatter_rows_launch.restype = ctypes.c_int
    return lib


def plan(width: int, dtype: torch.dtype, values_ptr: int, out_ptr: int) -> tuple:
    """``(access_bytes, tile)`` of the built kernel for rows of ``width``
    elements of ``dtype`` at these base addresses (``scatter_rows_plan``)."""
    access, tile = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().scatter_rows_plan(width, _DTYPE_CODE[dtype], values_ptr, out_ptr,
                                  ctypes.byref(access), ctypes.byref(tile))
    if rc != 0:
        raise RuntimeError(f"scatter_rows has no access width for rows of {width} {dtype}")
    return access.value, tile.value


def _launch(sorted_rows, perm, values, w, out, h, width):
    """Plans, sizes the scratch and launches."""
    lib = _lib()
    _, tile = plan(width, values.dtype, values.data_ptr(), out.data_ptr())
    n_ids = sorted_rows.shape[0]
    nbytes = lib.scatter_rows_scratch_bytes(-(-n_ids // tile), width)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=values.device)
    rc = lib.scatter_rows_launch(
        values.device.index or 0, sorted_rows.data_ptr(), perm.data_ptr(), values.data_ptr(),
        w.data_ptr() if w is not None else None, out.data_ptr(), n_ids, out.shape[0], width,
        max(h, 1), _DTYPE_CODE[values.dtype], scratch.data_ptr(), nbytes,
        torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: CUDA error {rc}")


def scatter_rows(sorted_rows: torch.Tensor, perm: torch.Tensor, values: torch.Tensor,
                 num_rows: int, w=None, h: int = 1) -> torch.Tensor:
    """The reduce-by-key on the card by ``csrc/scatter_rows.cu``; see
    module."""
    if not fake.on_card(values):
        return scatter_rows_plain(sorted_rows, perm, values, num_rows, w, h)
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"scatter_rows takes f32 or bf16 values, got {values.dtype}")
    if sorted_rows.dtype != torch.int32 or sorted_rows.ndim != 1:
        raise TypeError("sorted_rows must be int32 [N]")
    if perm.dtype != torch.int64 or tuple(perm.shape) != tuple(sorted_rows.shape):
        raise TypeError("perm must be int64 [N], sorted_rows' permutation")
    if values.ndim < 1 or h < 0 or values.shape[0] * h != sorted_rows.shape[0]:
        raise TypeError(f"values must be [N / h, ...] for N = {sorted_rows.shape[0]}, h = {h}")
    if w is not None and (w.dtype != values.dtype or w.numel() != sorted_rows.shape[0]):
        raise TypeError("w must be [N] in values' dtype")
    for name, t in (("sorted_rows", sorted_rows), ("perm", perm), ("w", w)):
        if t is not None and t.device != values.device:
            raise ValueError(f"{name} on {t.device}, values on {values.device}")
    if not all(t is None or t.is_contiguous() for t in (sorted_rows, perm, values, w)):
        raise ValueError("scatter_rows needs contiguous sorted_rows, perm, values and w")
    out = torch.empty((num_rows,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if out.numel() == 0:
        return out
    if fake.is_fake(values):
        fake.record("scatter_rows", fake.nbytes(sorted_rows, perm, values, w, out))
    else:
        _launch(sorted_rows, perm, values, w, out, h, math.prod(values.shape[1:]))
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0
