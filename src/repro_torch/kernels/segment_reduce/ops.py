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
version is taken only for tensors on the CPU or the meta device, and the
dry-run's fake tensors take the fake route (``kernels.fake``). The
kernel has two routes, by width alone (:func:`route`), both merge-path
tiles over the rows and the segment ends: rows of one element (the message
combiner's) take tiles of one chunk, counted in
``segment_reduce.launches_rows``; wider rows take tiles of several chunks
sized by the row's bytes, counted in ``segment_reduce.launches_cols``. The
wrapper sizes both routes' scratch (:func:`scratch_words`) with
:func:`n_tiles` at the built kernel's tiling for the width
(:func:`kernel_tiling`).

``segment_reduce_bwd(g, values, out, segment_ids, num_segments, op, mask,
offsets)`` is the values' gradient of ``segment_reduce`` for the output's
cotangent ``g``: sum gives each row its segment's cotangent; max and min
route it to the rows equal to the result, split evenly across ties with
JAX's rule (a segment whose result is the combiner's identity counts one
more tie); masked rows and rows outside every segment get 0; prod, or and
and have no gradient and raise. On the card the kernel
``csrc/segment_reduce_bwd.cu`` reads the offsets alone (no ids), one
launch for sum, a tie count and a write for max and min, counted in
``segment_reduce_bwd.launches`` and per route in ``launches_sum`` /
``launches_ties``; its plain version composes the plain gather and
segment reduction over the ids.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, fake
from repro_torch.kernels.gather_rows.ops import gather_rows_plain

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
    sentinel row that takes every dropped id and every masked row (the
    same result as masking the values to the identity, without an
    ``[E, ...]`` copy of them)."""
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
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    if mask is not None:  # a masked row goes to the sentinel row, as a dropped id
        ids = torch.where(mask, ids, n)
    index = ids.reshape(ids.shape + (1,) * (values.ndim - 1)).expand(work.shape)
    buf = torch.full(
        (n + 1,) + values.shape[1:], ident, dtype=work.dtype, device=values.device
    )
    buf.scatter_reduce_(0, index, work, _SCATTER_REDUCE[op], include_self=True)
    return buf[:n].to(values.dtype)


def route(width: int) -> str:
    """The kernel's route for rows of ``width`` elements: ``"rows"`` for one
    element, else ``"cols"``."""
    return "rows" if width == 1 else "cols"


def n_tiles(max_rows: int, num_segments: int, tile_items: int) -> int:
    """Tiles of ``tile_items`` merge items (rows + segment ends) the kernel
    needs for at most ``max_rows`` rows: every item the offsets can name,
    rounded up (tiles past the last item do nothing)."""
    return max(1, -(-(max_rows + num_segments) // tile_items))


def scratch_words(tiles: int, chunks: int, width: int) -> int:
    """The 4-byte words of scratch either route takes: the merge-path split
    at every chunk edge (``tiles * chunks + 1``), each tile's carried
    segment, and its carry and head partials, ``width`` words each."""
    return tiles * (chunks + 1 + 2 * width) + 1


@functools.cache
def _entry():
    """The C entry point of the kernel's library, typed."""
    fn = build.library("segment_reduce").segment_reduce_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def kernel_tiling(width: int, dtype: torch.dtype = torch.float32) -> tuple:
    """``(tile_items, chunks)``: merge items a tile and chunks a tile for
    rows of ``width`` elements of ``dtype``, as the built kernel has them
    (``segment_reduce_tile_items`` of csrc/segment_reduce.cu: the rows
    route's ``kTile`` in one chunk, the cols route's ``kColsChunks`` chunks
    of as many rows as ``kColsChunkBytes`` hold)."""
    fn = build.library("segment_reduce").segment_reduce_tile_items
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    chunks = ctypes.c_int(0)
    items = fn(width, _DTYPE_CODE[dtype], ctypes.byref(chunks))
    return int(items), chunks.value


def _launch(values, mask, offsets, out, op, width):
    tile, chunks = kernel_tiling(width, values.dtype)
    tiles = n_tiles(values.shape[0], out.shape[0], tile)
    words = scratch_words(tiles, chunks, width)
    scratch = torch.empty(words, dtype=torch.int32, device=values.device)
    fn = _entry()
    rc = fn(
        values.device.index or 0,
        values.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        offsets.data_ptr(),
        out.data_ptr(),
        offsets.shape[0] - 1,
        width,
        _DTYPE_CODE[values.dtype],
        _OP_CODE[op],
        scratch.data_ptr(),
        tiles,
        words,
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
    if not fake.on_card(values):
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
    width = math.prod(values.shape[1:])
    if fake.is_fake(values):
        fake.record("segment_reduce", fake.nbytes(values, mask, offsets, out))
    else:
        _launch(values, mask, offsets, out, op, width)
    segment_reduce.launches += 1
    if route(width) == "rows":
        segment_reduce.launches_rows += 1
    else:
        segment_reduce.launches_cols += 1
    return out


segment_reduce.launches = 0
segment_reduce.launches_rows = 0
segment_reduce.launches_cols = 0


# -- the values' gradient ------------------------------------------------------

#: the combiners with a gradient
GRAD_OPS = ("sum", "max", "min")


def _in_segment(segment_ids, n, mask):
    """int32 ids with every row outside ``[0, n)`` or masked off at ``n``."""
    ok = (segment_ids >= 0) & (segment_ids < n)
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, segment_ids, n).to(torch.int32).contiguous()


def _no_gradient(op):
    if op not in GRAD_OPS:
        raise NotImplementedError(f"segment_reduce {op!r} has no gradient in the port")


def segment_reduce_bwd_plain(g, values, out, segment_ids, num_segments: int, op: str,
                             mask=None, offsets=None):
    """The plain version: the cotangent gathered by segment id (sum), or
    the ties found on a gathered copy of ``out``, counted by a segment sum
    and each given its share (max, min), through the plain gather and
    segment reduction (``offsets`` are not read)."""
    _no_gradient(op)
    n = num_segments
    g = g.contiguous()
    if op == "sum":
        return gather_rows_plain(g, _in_segment(segment_ids, n, mask), 0.0)
    ident = identity(op, values.dtype)
    rows = _in_segment(segment_ids, n, None)
    eff = values
    if mask is not None:  # JAX reduces the identity in place of a masked row
        eff = torch.where(mask.reshape(mask.shape + (1,) * (values.ndim - 1)), values, ident)
    ties = eff == gather_rows_plain(out.contiguous(), rows, math.nan)
    count = segment_reduce_plain(ties.to(torch.float32), segment_ids, n, "sum")
    count = count + (out == ident).to(torch.float32)
    coef = g.float() * torch.where(count > 0, 1.0 / count, 0.0)
    share = gather_rows_plain(coef.contiguous(), rows, 0.0)
    if mask is not None:
        ties = ties & mask.reshape(mask.shape + (1,) * (values.ndim - 1))
    return torch.where(ties, share, 0.0).to(values.dtype)


@functools.cache
def _bwd_entry():
    """The C entry point of the backward's library, typed."""
    fn = build.library("segment_reduce_bwd").segment_reduce_bwd_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _bwd_launch(g, values, out, offsets, mask, dv, op):
    """Launches the backward (max and min with their tie-count scratch)."""
    n, width = g.shape[0], math.prod(dv.shape[1:])
    extremum = op != "sum"
    count = torch.empty(n * width, dtype=torch.int32, device=g.device) if extremum else None
    rc = _bwd_entry()(
        g.device.index or 0, _OP_CODE[op], _DTYPE_CODE[g.dtype], g.data_ptr(),
        values.data_ptr() if extremum else None, out.data_ptr() if extremum else None,
        offsets.data_ptr(), mask.data_ptr() if mask is not None else None, dv.data_ptr(), n,
        dv.shape[0], width, count.data_ptr() if extremum else None,
        torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_reduce_bwd kernel launch failed: CUDA error {rc}")


def segment_reduce_bwd(g, values, out, segment_ids, num_segments: int, op: str, mask=None,
                       offsets=None):
    """The values' gradient on the card by ``csrc/segment_reduce_bwd.cu``;
    see module. On the card ``segment_ids`` give only the row count:
    ``offsets`` carry the segmentation, as for the forward."""
    if not fake.on_card(g):
        return segment_reduce_bwd_plain(g, values, out, segment_ids, num_segments, op, mask,
                                        offsets)
    _no_gradient(op)
    n = num_segments
    g = g.contiguous()
    if g.dtype not in (torch.float32, torch.bfloat16) or g.shape[0] != n:
        raise TypeError(f"g must be f32 or bf16 [{n}, ...], got {g.dtype} {tuple(g.shape)}")
    if offsets is None or offsets.dtype != torch.int32 or tuple(offsets.shape) != (n + 1,):
        raise TypeError(f"offsets must be int32 [{n + 1}] on the card")
    shape = tuple(segment_ids.shape[:1]) + tuple(g.shape[1:])
    if op != "sum":
        if values is None or out is None or tuple(values.shape) != shape or \
                tuple(out.shape) != tuple(g.shape) or not values.dtype == out.dtype == g.dtype:
            raise TypeError(f"values {shape} and out {tuple(g.shape)} must be in g's dtype")
        values, out = values.contiguous(), out.contiguous()
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != shape[:1]):
        raise TypeError("mask must be bool [E]")
    for name, t in (("offsets", offsets), ("mask", mask), ("values", values), ("out", out)):
        if t is not None and t.device != g.device:
            raise ValueError(f"{name} on {t.device}, g on {g.device}")
    if not (offsets.is_contiguous() and (mask is None or mask.is_contiguous())):
        raise ValueError("segment_reduce_bwd needs contiguous offsets and mask")
    dv = torch.empty(shape, dtype=g.dtype, device=g.device)
    if dv.numel() == 0:
        return dv
    if fake.is_fake(g):
        read = (values, out) if op != "sum" else ()
        fake.record("segment_reduce_bwd", fake.nbytes(g, offsets, mask, dv, *read))
    else:
        _bwd_launch(g, values, out, offsets, mask, dv, op)
    segment_reduce_bwd.launches += 1
    if op == "sum":
        segment_reduce_bwd.launches_sum += 1
    else:
        segment_reduce_bwd.launches_ties += 1
    return dv


segment_reduce_bwd.launches = 0
segment_reduce_bwd.launches_sum = 0
segment_reduce_bwd.launches_ties = 0
