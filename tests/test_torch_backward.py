"""The two backward kernels' plain versions against the JAX package, and a
model of how each kernel cuts its work, on the CPU.

``csrc/scatter_rows.cu`` (the table gradient of a row gather and of an
embedding bag) and ``csrc/segment_reduce_bwd.cu`` (``segment_reduce``'s
values gradient) run only on the card, where ``chip_smoke.py`` holds each
against the plain version tested here:

* ``scatter_rows_plain`` against ``jax.grad`` of ``repro.graph.ops.gather``
  (clip and fill modes: ``jnp.take``'s scatter-add) and of
  ``embedding_bag_ref`` (weighted bags of 1 and 3 slots);
* ``segment_reduce_bwd_plain`` against ``jax.grad`` of
  ``repro.graph.ops.segment_reduce`` (sum, max and min; masks, ties, a
  segment whose result is the identity, empty segments, offsets that start
  above 0 and sentinel rows past the last segment);
* a pure-Python model of each kernel's split, its constants read from the
  source: K1's tiles of sorted positions, its groups' runs, the in-tile fold
  and the ordered fix-up of runs that cross tiles; K2's rows a block, the
  block's search of all its threads, each row's search between the two
  segments it found and the tie counts a group adds per segment, against
  float64 numpy.

Tolerances: ``TOL`` of tests/test_kernels.py (f32 2e-5, bf16 3e-2),
relative, the absolute part scaled by max|want| (the sums run in another
order; JAX's bf16 scatter-add accumulates in bf16, the port in f32); exact
where every input is a multiple of 1/16 and the sums stay small (every
partial sum is then exact in f32): against JAX in f32, against the float64
sum rounded once in bf16. Tie counts and the models' shares exactly.
"""

import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph import ops as jops  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.graph.structure import segment_offsets  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.scatter_rows import scatter_rows, scatter_rows_plain  # noqa: E402
from repro_torch.kernels.segment_reduce import (  # noqa: E402
    segment_reduce_bwd,
    segment_reduce_bwd_plain,
    segment_reduce_plain,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(TORCH[dtype])


def _j(x: np.ndarray, dtype: str):
    return jnp.asarray(np.array(x, np.float32)).astype(JNP[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _close(got, want, dtype: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max(initial=0)), 1e-30))


def _values(rng, shape, exact: bool) -> np.ndarray:
    """k/16 values (exact sums) or normal ones."""
    if exact:
        return rng.integers(-16, 17, size=shape).astype(np.float32) / 16
    return rng.normal(size=shape).astype(np.float32)


def _exact_sum(values64: np.ndarray, rows: np.ndarray, n: int) -> np.ndarray:
    """The float64 sum of ``values64``' rows by ``rows`` into ``n`` rows,
    rows outside ``[0, n)`` dropped."""
    out = np.zeros((n,) + values64.shape[1:])
    ok = (rows >= 0) & (rows < n)
    np.add.at(out, rows[ok], values64[ok])
    return out


# -- scatter_rows_plain against jax.grad -----------------------------------------

N_ROWS = 40
#: a hub (row 7, 300 ids), every row once, and ids -1, -3, -N, -N-1, N and
#: 2^31 - 1 (clipped into the table, or in fill mode wrapped or dropped)
GATHER_IDS = np.concatenate([
    np.full(300, 7), np.arange(N_ROWS),
    [3, 3, -1, -3, -N_ROWS, -N_ROWS - 1, N_ROWS, 2**31 - 1],
]).astype(np.int32)


def _gather_rows_of(ids: np.ndarray, n: int, fill) -> np.ndarray:
    """The table row each id's cotangent goes to: the gather backward's
    clamp (clip mode) or wrap (fill mode; the rest fall outside)."""
    ids = ids.astype(np.int64)
    if fill is None:
        return np.clip(ids, 0, n - 1)
    return np.where(ids < 0, ids + n, ids)


def _sorted(rows: np.ndarray):
    return torch.sort(torch.from_numpy(rows.astype(np.int32)), stable=True)


@pytest.mark.parametrize("exact", [True, False], ids=["k16", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [None, 5], ids=["rows", "rows5"])
@pytest.mark.parametrize("fill", [None, 0.5], ids=["clip", "fill"])
def test_scatter_rows_plain_is_gather_grad(fill, width, dtype, exact):
    """``scatter_rows_plain`` over the sorted clamped or wrapped ids ==
    ``jax.grad`` of ``repro.graph.ops.gather``: the hub summed, ids outside
    the table clipped (clip) or wrapped and dropped (fill)."""
    rng = np.random.default_rng(0)
    ids = rng.permutation(GATHER_IDS)
    shape = (N_ROWS,) if width is None else (N_ROWS, width)
    cot = _values(rng, ids.shape + shape[1:], exact)
    table = _j(rng.normal(size=shape), dtype)
    jcot = _j(cot, dtype)
    want = jax.grad(lambda f: jnp.sum(jops.gather(f, jnp.asarray(ids), fill) * jcot))(table)
    rows = _gather_rows_of(ids, N_ROWS, fill)
    sorted_rows, perm = _sorted(rows)
    got = scatter_rows_plain(sorted_rows, perm, _t(cot, dtype), N_ROWS)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == shape
    if exact:  # f32 sums of k/16 are exact in both; bf16: the exact sum rounded once
        exact_sum = _exact_sum(_np(_t(cot, dtype)), rows, N_ROWS)
        np.testing.assert_array_equal(_np(got), _np(_t(exact_sum, dtype)))
        if dtype == "float32":
            np.testing.assert_array_equal(_np(got), _np(want))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_rows_plain_empty_input(dtype):
    """No ids: every row is zero (the kernel's C entry zeroes the output)."""
    sorted_rows, perm = _sorted(np.zeros(0, np.int64))
    got = scatter_rows_plain(sorted_rows, perm, torch.zeros((0, 3), dtype=TORCH[dtype]), 6)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (6, 3)
    assert not bool(got.any())
    empty_bags = scatter_rows_plain(sorted_rows, perm, torch.zeros((4, 3)), 6, h=0)
    assert tuple(empty_bags.shape) == (6, 3) and not bool(empty_bags.any())


@pytest.mark.parametrize("exact", [True, False], ids=["k16", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slots", [1, 3])
def test_scatter_rows_plain_is_bag_table_grad(slots, dtype, exact):
    """``scatter_rows_plain`` with ``h`` slots a bag and the per-slot
    weights == the table gradient of ``embedding_bag_ref`` under
    ``jax.grad``: weighted bags, a hub id, ids -1, V and 2^31 - 1 clipped."""
    rng = np.random.default_rng(1)
    v, d, b = 25, 8, 40
    idx = rng.integers(0, v, (b, slots)).astype(np.int32)
    idx[: b // 2, 0] = 4
    idx[0, 0], idx[1, 0], idx[2, 0] = -1, v, 2**31 - 1
    w = _values(rng, (b, slots), exact)
    cot = _values(rng, (b, d), exact)
    jt = _j(rng.normal(size=(v, d)), dtype)
    jw, jcot = _j(w, dtype), _j(cot, dtype)
    want = jax.grad(lambda t: jnp.sum(embedding_bag_ref(t, jnp.asarray(idx), jw) * jcot))(jt)
    rows = np.clip(idx.reshape(-1).astype(np.int64), 0, v - 1)
    sorted_rows, perm = _sorted(rows)
    got = scatter_rows_plain(sorted_rows, perm, _t(cot, dtype), v,
                             _t(w.reshape(-1), dtype), slots)
    assert got.dtype == TORCH[dtype]
    if exact:
        slot_g = _np(_t(cot, dtype)).repeat(slots, 0) * _np(_t(w, dtype)).reshape(-1, 1)
        np.testing.assert_array_equal(_np(got), _np(_t(_exact_sum(slot_g, rows, v), dtype)))
    _close(got, want, dtype)


def test_scatter_rows_wrapper_takes_plain_on_cpu():
    """On CPU tensors the wrapper is its plain version and counts nothing."""
    rng = np.random.default_rng(2)
    rows = rng.integers(-2, 12, 200)
    sorted_rows, perm = _sorted(rows)
    vals = torch.from_numpy(rng.normal(size=(200, 4)).astype(np.float32))
    before = scatter_rows.launches
    assert torch.equal(scatter_rows(sorted_rows, perm, vals, 10),
                       scatter_rows_plain(sorted_rows, perm, vals, 10))
    assert scatter_rows.launches == before


# -- segment_reduce_bwd_plain against jax.grad -----------------------------------

SEG_N = 14
#: ascending ids: two dropped below (offsets[0] = 2), empty segments 0, 5,
#: 11 and 12, a hub (segment 3, 40 rows), segment 9 all masked where a mask
#: is given (its max/min is then the identity), three sentinel rows past the
#: last segment
SEG_IDS = np.concatenate([
    [-2, -1], np.full(2, 1), np.full(4, 2), np.full(40, 3), [4], np.full(5, 6),
    np.full(3, 7), np.full(6, 8), np.full(3, 9), np.full(4, 10), [13],
    [SEG_N, SEG_N, SEG_N],
]).astype(np.int32)


def _seg_values(rng, op, width, dtype):
    """k/4 values (many ties), every extremum planted twice in segment 3
    and three times in segment 8 (first column)."""
    shape = SEG_IDS.shape + (() if width is None else (width,))
    vals = rng.integers(-4, 5, size=shape).astype(np.float32) / 4
    if op in ("max", "min"):
        for seg, n in ((3, 2), (8, 3)):
            vals[np.flatnonzero(SEG_IDS == seg)[:n]] = 9.0 if op == "max" else -9.0
    return vals


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [None, 3], ids=["rows", "rows3"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_reduce_bwd_plain_is_jax_grad(op, masked, width, dtype):
    """``segment_reduce_bwd_plain`` == ``jax.grad`` of
    ``repro.graph.ops.segment_reduce``: sum's cotangent per segment, max and
    min split across ties (a masked-out segment's identity result counts
    one more tie), dropped rows before ``offsets[0]`` and past the last
    segment, empty segments, a hub."""
    rng = np.random.default_rng(3)
    vals = _seg_values(rng, op, width, dtype)
    mask = None
    if masked:
        mask = rng.random(SEG_IDS.shape[0]) < 0.8
        mask[SEG_IDS == 9] = False
        if op in ("max", "min"):
            mask[np.flatnonzero(SEG_IDS == 8)[0]] = False  # a masked-off tie does not split
    cot = rng.normal(size=(SEG_N,) + vals.shape[1:]).astype(np.float32)
    jv = _j(vals, dtype)
    jcot = _j(cot, dtype)

    def jfun(v):
        out = jops.segment_reduce(v, jnp.asarray(SEG_IDS), SEG_N, op, indices_are_sorted=True,
                                  mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0) * jcot)

    want = jax.grad(jfun)(jv)
    ids = torch.from_numpy(SEG_IDS)
    tv, tmask = _t(vals, dtype), None if mask is None else torch.from_numpy(mask)
    out = segment_reduce_plain(tv, ids, SEG_N, op, tmask) if op != "sum" else None
    offsets = segment_offsets(ids, SEG_N)
    assert int(offsets[0]) == 2 and int(offsets[-1]) == SEG_IDS.shape[0] - 3
    got = segment_reduce_bwd_plain(_t(cot, dtype), tv, out, ids, SEG_N, op, tmask, offsets)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == vals.shape
    _close(got, want, dtype)
    if op == "sum" and dtype == "float32":
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_reduce_bwd_plain_empty_input(op):
    """No rows: an empty gradient of the values' shape."""
    ids = torch.zeros(0, dtype=torch.int32)
    vals = torch.zeros((0, 3))
    out = segment_reduce_plain(vals, ids, 4, op) if op != "sum" else None
    got = segment_reduce_bwd(torch.ones((4, 3)), vals, out, ids, 4, op,
                             offsets=segment_offsets(ids, 4))
    assert tuple(got.shape) == (0, 3)


def test_segment_reduce_bwd_identity_tie_exact():
    """JAX's tie rule exactly, in bf16 too: three equal maxima take a third
    each; an all-masked segment (result -inf) counts the initial value as
    a tie, and its masked rows get nothing."""
    vals = np.array([2.0, 2.0, 2.0, 1.0, 5.0, 7.0], np.float32)
    ids = np.array([0, 0, 0, 0, 1, 1], np.int32)
    mask = np.array([True, True, True, True, False, False])
    cot = np.array([3.0, 6.0], np.float32)
    for dtype in ("float32", "bfloat16"):
        want = jax.grad(lambda v: jnp.sum(jnp.where(jnp.isfinite(o := jops.segment_reduce(
            v, jnp.asarray(ids), 2, "max", mask=jnp.asarray(mask))), o, 0) * _j(cot, dtype)))(
            _j(vals, dtype))
        tv, tm = _t(vals, dtype), torch.from_numpy(mask)
        tids = torch.from_numpy(ids)
        out = segment_reduce_plain(tv, tids, 2, "max", tm)
        got = segment_reduce_bwd_plain(_t(cot, dtype), tv, out, tids, 2, "max", tm)
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(got), [1.0, 1.0, 1.0, 0.0, 0.0, 0.0])


@pytest.mark.parametrize("op", ["prod", "or", "and"])
def test_segment_reduce_bwd_raises_without_rule(op):
    """prod, or and and have no gradient: both versions raise."""
    ids = torch.tensor([0, 0, 1], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=op):
        segment_reduce_bwd_plain(torch.ones(2), torch.ones(3), torch.ones(2), ids, 2, op)
    with pytest.raises(NotImplementedError, match=op):
        segment_reduce_bwd(torch.ones(2), torch.ones(3), torch.ones(2), ids, 2, op)


# -- the kernels' splits, modelled ---------------------------------------------


def _constants(name: str) -> dict:
    """The ``constexpr int k...`` constants of csrc/<name>.cu."""
    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _row_access(row_bytes: int, elem: int) -> int:
    """``rows::row_access`` at aligned base addresses: the widest of 16, 8,
    4, 2 bytes that divides the row, never below an element."""
    return next(a for a in (16, 8, 4, 2) if a >= elem and row_bytes % a == 0)


def _lanes(units: int) -> int:
    """``rows::row_lanes``: the power of two at or above ``units``, at most 32."""
    return min(32, 1 << max(units - 1, 0).bit_length())


def _k1_geom(width: int, elem: int = 4):
    """``(groups, span)`` of csrc/scatter_rows.cu for rows of ``width``
    elements: ``kThreads / lanes`` groups, each over at most ``kSpan``
    positions, a tile of at most ``kTileMax``."""
    c = _constants("scatter_rows")
    units = width * elem // _row_access(width * elem, elem)
    groups = c["kThreads"] // _lanes(units)
    return groups, min(c["kSpan"], c["kTileMax"] // groups)


def k1_model(ids, perm, values, n, groups, span, w=None, h=1):
    """``scatter_tiles`` then ``scatter_fixup`` of csrc/scatter_rows.cu, one
    column vector at a time (a slice of columns does the same arithmetic):
    returns the f32 output and how often each row was written."""
    width = values.shape[1]
    tile = groups * span
    n_ids = len(ids)
    n_tiles = -(-n_ids // tile)
    out = np.zeros((n, width), np.float32)
    writes = np.zeros(n, np.int64)
    flags = np.zeros(n_tiles, np.int64)
    tile_row = np.zeros(n_tiles, np.int64)
    part = np.zeros((n_tiles, width), np.float32)
    carry = np.zeros((n_tiles, width), np.float32)

    def valid(r):
        return 0 <= r < n

    def write(r, v):
        out[r] = v
        writes[r] += 1

    for k in range(n_tiles):
        t0 = k * tile
        nn = min(tile, n_ids - t0)

        def head(i):
            return t0 + i in (0, n_ids) or ids[t0 + i] != ids[t0 + i - 1]

        firsts, lasts, has, keys = [], [], [], []
        for q in range(groups):
            acc = np.zeros(width, np.float32)
            first = np.zeros(width, np.float32)
            hq, key = False, 0
            for i in range(q * span, min(q * span + span, nn)):
                if i > 0 and head(i):  # the run of ids[t0 + i - 1] ends
                    r = ids[t0 + i - 1]
                    if not hq:
                        first, key, hq = acc, r, True
                    elif valid(r):
                        write(r, acc)
                    acc = np.zeros(width, np.float32)
                if valid(ids[t0 + i]):
                    slot = perm[t0 + i]
                    wt = np.float32(1) if w is None else w[slot]
                    acc = acc + wt * values[slot // h]
            firsts.append(first)
            lasts.append(acc)
            has.append(hq)
            keys.append(key)
        run = np.zeros(width, np.float32)
        began_before = not head(0)
        opened = began_before
        for q in range(groups):
            if has[q]:
                v = run + firsts[q]
                if opened:
                    part[k] = v
                elif valid(keys[q]):
                    write(keys[q], v)
                opened = False
                run = lasts[q]
            else:
                run = run + lasts[q]
        ends, last_id = head(nn), ids[t0 + nn - 1]
        if opened:
            part[k] = run
        elif not ends:
            carry[k] = run
        elif valid(last_id):
            write(last_id, run)
        inside = began_before and not any(has)
        flags[k] = (1 if not inside and not ends and valid(last_id) else 0) | (
            2 if inside and not ends else 0)
        tile_row[k] = last_id
    for k in np.flatnonzero(flags & 1):
        acc, m = carry[k], k + 1
        while True:
            acc = acc + part[m]
            if not flags[m] & 2:
                break
            m += 1
        write(tile_row[k], acc)
    return out, writes


def _run_ids(rng, layout: str, n: int, tile: int) -> np.ndarray:
    """Ids in a layout that crosses tiles of ``tile`` positions."""
    if layout == "hub":  # one run over more than three tiles among short ones
        ids = np.concatenate([rng.integers(0, n, 3 * tile), np.full(3 * tile + tile // 2, 5)])
    elif layout == "tile_runs":  # runs of exactly a tile and a tile +- 1
        ids = np.repeat(np.arange(6), [tile, tile + 1, tile - 1 if tile > 1 else 1, 1, 2 * tile, 3])
    elif layout == "dropped":  # runs of ids below 0 and at or above n across tiles
        ids = np.concatenate([np.full(2 * tile + 1, -3), rng.integers(-2, n + 2, 4 * tile),
                              np.full(tile + 2, n + 7)])
    else:  # "short": runs of 1-3
        ids = np.repeat(rng.permutation(n)[: n // 2], rng.integers(1, 4, n // 2))
    return rng.permutation(ids.astype(np.int64))


K1_WIDTHS = [(1, 4), (4, 4), (16, 4), (64, 4), (75, 4), (16, 2), (75, 2)]


@pytest.mark.parametrize("layout", ["hub", "tile_runs", "dropped", "short"])
@pytest.mark.parametrize("tiling", [(1, 1), (2, 3), (4, 2), (3, 5), "kernel"])
@pytest.mark.parametrize("width", [1, 16, 75])
def test_scatter_rows_model_matches_float64(width, tiling, layout):
    """K1's split: every row that some id names is written exactly once, by
    its group, the in-tile fold or the fix-up, and the others stay 0; sums
    within ``TOL`` · Σ|x| of float64, and exact for k/16 values. ``tiling``
    is (groups, span), or the kernel's own for the width."""
    rng = np.random.default_rng(4)
    groups, span = _k1_geom(width) if tiling == "kernel" else tiling
    n = 30
    ids = _run_ids(rng, layout, n, min(groups * span, 64))
    sorted_ids = np.sort(ids, kind="stable")
    perm = np.argsort(ids, kind="stable")
    named = np.zeros(n, bool)
    named[sorted_ids[(sorted_ids >= 0) & (sorted_ids < n)]] = True
    for exact in (True, False):
        vals = _values(rng, (len(ids), width), exact)
        got, writes = k1_model(sorted_ids, perm, vals, n, groups, span)
        np.testing.assert_array_equal(writes, named.astype(np.int64))
        want = _exact_sum(vals.astype(np.float64), ids, n)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            mag = _exact_sum(np.abs(vals.astype(np.float64)), ids, n)
            assert np.all(np.abs(got - want) <= TOL["float32"] * mag + 1e-30)


@pytest.mark.parametrize("slots", [1, 3])
@pytest.mark.parametrize("tiling", [(2, 3), "kernel"])
def test_scatter_rows_model_weighted_bags(tiling, slots):
    """K1's split with ``h`` slots a bag and per-slot weights: the bag's
    value row times the slot's weight, exact for k/16 values."""
    rng = np.random.default_rng(5)
    groups, span = _k1_geom(16) if tiling == "kernel" else tiling
    b, n = 300, 20
    ids = np.concatenate([np.full(b * slots // 2, 3), rng.integers(0, n, b * slots - b * slots // 2)])
    ids = rng.permutation(ids)
    vals, w = _values(rng, (b, 16), True), _values(rng, (b * slots,), True)
    sorted_ids, perm = np.sort(ids, kind="stable"), np.argsort(ids, kind="stable")
    got, _ = k1_model(sorted_ids, perm, vals, n, groups, span, w=w, h=slots)
    slot_g = vals.astype(np.float64).repeat(slots, 0) * w.astype(np.float64)[:, None]
    np.testing.assert_array_equal(got, _exact_sum(slot_g, ids, n))


@pytest.mark.parametrize("width,elem", K1_WIDTHS)
def test_scatter_rows_kernel_tiling(width, elem):
    """The kernel's tile for each width stays within ``kTileMax`` positions
    and its staged ids, permutation and partials within 48 KB of static
    shared memory."""
    c = _constants("scatter_rows")
    groups, span = _k1_geom(width, elem)
    assert groups * span <= c["kTileMax"] and span <= c["kSpan"]
    per_unit = _row_access(width * elem, elem) // elem
    smem = (c["kTileMax"] + 2) * 4 + c["kTileMax"] * 8 + 2 * c["kThreads"] * 8 * 4 \
        + c["kThreads"] * 8
    assert per_unit <= 8 and smem <= 48 * 1024


def block_segment(offsets, n_seg, i, threads):
    """``block_segment`` of csrc/segment_reduce_bwd.cu: every thread probes
    one point of the range a round, and the count of probes at or below
    ``i`` narrows it. Returns the segment and the rounds taken."""
    lo, hi, rounds = 0, n_seg - 1, 0
    while lo < hi:
        span = hi - lo + 1
        probes = [lo + span * t // threads for t in range(threads)]
        t = sum(offsets[p] <= i for p in probes) - 1
        lo, hi = probes[t], (probes[t + 1] - 1 if t + 1 < threads else hi)
        rounds += 1
    return lo, rounds


def row_segment(offsets, lo, hi, i):
    """``row_segment``: the last s in ``[lo, hi]`` with ``offsets[s] <= i``."""
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if offsets[mid] <= i:
            lo = mid
        else:
            hi = mid - 1
    return lo


def k2_model(offsets, n_rows, op, g, values=None, out=None, mask=None, groups=16, rows=8,
             threads=256):
    """``bwd_sum`` / ``bwd_ties`` then ``bwd_write`` of
    csrc/segment_reduce_bwd.cu for blocks of ``groups`` groups of ``rows``
    consecutive rows: returns the gradient, the tie counts and the number
    of atomic adds."""
    n = len(offsets) - 1
    width = g.shape[1]
    lo_row, hi_row = offsets[0], offsets[n]
    seg = np.full(n_rows, -1)
    count = np.zeros((n, width), np.int64)
    adds = 0
    per_block = groups * rows
    for i0 in range(0, n_rows, per_block):
        i1 = min(i0 + per_block, n_rows)
        r0, r1 = max(i0, lo_row), min(i1, hi_row)
        sa, sb = 0, -1
        if r0 < r1:
            sa = block_segment(offsets, n, r0, threads)[0]
            sb = block_segment(offsets, n, r1 - 1, threads)[0]
        for first in range(i0, i1, rows):
            cur, cnt = -1, np.zeros(width, np.int64)
            for i in range(first, min(first + rows, i1)):
                if not lo_row <= i < hi_row:
                    continue
                seg[i] = s = row_segment(offsets, sa, sb, i)
                if op == "sum":
                    continue
                if s != cur:
                    if cur >= 0:
                        count[cur] += cnt
                        adds += int((cnt > 0).sum())
                    cur, cnt = s, np.zeros(width, np.int64)
                ident = -np.inf if op == "max" else np.inf
                v = values[i] if mask is None or mask[i] else np.full(width, ident)
                cnt += v == out[s]
            if cur >= 0:
                count[cur] += cnt
                adds += int((cnt > 0).sum())
    dv = np.zeros((n_rows, width), np.float32)
    for i in range(n_rows):
        s = seg[i]
        if s < 0 or (mask is not None and not mask[i]):
            continue
        if op == "sum":
            dv[i] = g[s]
            continue
        ident = -np.inf if op == "max" else np.inf
        ties = (count[s] + (out[s] == ident)).astype(np.float32)
        share = g[s] * (np.float32(1) / np.maximum(ties, 1))
        dv[i] = np.where(values[i] == out[s], share, np.float32(0))
    return dv, count, adds


def _seg_layout(rng, layout: str, span: int):
    """Segment lengths, rows dropped below the first segment and sentinel
    rows past the last, for blocks of ``span`` rows."""
    if layout == "hub":  # one segment over more than three blocks
        lengths = rng.integers(0, 4, 40)
        lengths[9] = 3 * span + span // 3
        return lengths, 3, 4
    if layout == "empty_runs":  # long runs of empty segments inside blocks
        lengths = np.zeros(600, np.int64)
        lengths[rng.choice(600, 30, replace=False)] = rng.integers(1, 6, 30)
        return lengths, 0, 0
    if layout == "edges":  # segments ending on block edges
        return np.array([span, span - 1 if span > 1 else 1, 1, span + 1, 0, 2 * span]), 1, 2
    return rng.integers(0, 6, 120), 0, 2  # "short"


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("layout", ["hub", "empty_runs", "edges", "short"])
@pytest.mark.parametrize("blocking", [(1, 1), (2, 3), (4, 8), (3, 5)])
def test_segment_reduce_bwd_model_matches(blocking, layout, op):
    """K2's split: each row's segment from the block's two searches and its
    own, the tie counts added per group and segment equal to a whole count
    per segment, and the gradient equal to the plain version bit for bit
    (masked rows, dropped rows, ties, all-masked segments)."""
    rng = np.random.default_rng(6)
    groups, rows = blocking
    lengths, below, above = _seg_layout(rng, layout, groups * rows)
    n = len(lengths)
    ids = np.concatenate([np.full(below, -1), np.repeat(np.arange(n), lengths),
                          np.full(above, n)]).astype(np.int32)
    e, width = len(ids), 3
    vals = rng.integers(-2, 3, (e, width)).astype(np.float32) / 2  # many ties
    mask = rng.random(e) < 0.7
    g = rng.normal(size=(n, width)).astype(np.float32)
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    offsets = segment_offsets(tids, n)
    out = None
    if op != "sum":
        out = segment_reduce_plain(torch.from_numpy(vals), tids, n, op, tmask)
    got, count, adds = k2_model(offsets.numpy().astype(np.int64), e, op, g, vals,
                                None if out is None else out.numpy(), mask, groups, rows,
                                threads=16)
    want = segment_reduce_bwd_plain(torch.from_numpy(g), torch.from_numpy(vals), out, tids, n,
                                    op, tmask, offsets)
    np.testing.assert_array_equal(got, want.numpy())
    if op != "sum":
        ident = -np.inf if op == "max" else np.inf
        eff = np.where(mask[:, None], vals, ident)
        whole = np.zeros((n, width), np.int64)
        ok = (ids >= 0) & (ids < n)
        np.add.at(whole, ids[ok], (eff[ok] == out.numpy()[ids[ok]]).astype(np.int64))
        np.testing.assert_array_equal(count, whole)
        assert adds <= int((whole > 0).sum()) + (e // rows + 1) * width


@pytest.mark.parametrize("threads", [2, 16, 256])
@pytest.mark.parametrize("n_seg", [1, 2, 7, 300, 70_000])
def test_block_segment_search(n_seg, threads):
    """The block's search finds the last segment starting at or before each
    row (empty segments skipped) in about log_threads(n) rounds."""
    rng = np.random.default_rng(7)
    lengths = rng.integers(0, 3, n_seg) * (rng.random(n_seg) < 0.6)
    lengths[0] = max(lengths[0], 1)
    offsets = np.concatenate([[5], 5 + np.cumsum(lengths)])
    rows = np.unique(np.concatenate([rng.integers(offsets[0], offsets[-1], 40),
                                     [offsets[0], offsets[-1] - 1]]))
    for i in rows:
        got, rounds = block_segment(offsets, n_seg, int(i), threads)
        assert got == int(np.searchsorted(offsets, i, side="right")) - 1
        assert rounds <= max(1, math.ceil(math.log(n_seg, threads)) + 1)
        assert row_segment(offsets, 0, n_seg - 1, int(i)) == got


def test_kernel_sources_register():
    """Both kernels are built with the others and share the row access of
    ``csrc/rows.cuh`` (so their libraries rebuild when it changes)."""
    assert {"scatter_rows", "segment_reduce_bwd"} <= set(build.KERNELS)
    for name in ("scatter_rows", "segment_reduce_bwd"):
        assert build.CSRC_DIR / "rows.cuh" in build.sources(name)
    assert pathlib.Path(build.CSRC_DIR / "rows.cuh").exists()
