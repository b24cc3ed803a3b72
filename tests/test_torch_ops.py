"""The port's graph substrate against the JAX package, on the CPU.

``scatter_combine`` (every combiner, masks, dropped and wrapped indices),
``combine``/``combine_along_axis``, degrees, ``edge_softmax``, and the
``Graph`` carrier: the port's generators and ``from_arrays`` give the JAX
``Graph`` leaf for leaf, plus segment offsets that agree with the sorted
ids. Everything is exact except float sums (f32 ``TOL`` of
tests/test_kernels.py, rtol = atol = 2e-5: the summation order differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph import generators as JG  # noqa: E402
from repro.graph import ops as jops  # noqa: E402
from repro.graph import structure as JS  # noqa: E402
from repro_torch.graph import generators as TG  # noqa: E402
from repro_torch.graph import ops as tops  # noqa: E402
from repro_torch.graph import structure as TS  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
OPS = ("sum", "prod", "min", "max", "or", "and")


def _leaves(g):
    return {k: np.asarray(getattr(g, k)) for k in TS.EDGE_ARRAYS}


GRAPHS = {
    "er_undirected": lambda m: m.erdos_renyi(80, 4.0, directed=False, weighted=True, seed=1),
    "er_directed": lambda m: m.erdos_renyi(80, 4.0, directed=True, seed=2),
    "rmat7": lambda m: m.rmat(7, avg_degree=4.0, directed=True, weighted=True, seed=3),
    "grid": lambda m: m.grid2d(6, 7),
    "star": lambda m: m.star(20),
    "chain": lambda m: m.chain(15, weighted=True, seed=4),
}


def _port(make):
    """Call a generator of the port's module on the CPU."""

    class _CPU:
        def __getattr__(self, name):
            fn = getattr(TG, name)
            return lambda *a, **kw: fn(*a, device="cpu", **kw)

    return make(_CPU())


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_graph_matches_jax(kind):
    """Port generator == JAX generator leaf for leaf; ``from_arrays`` of the
    JAX leaves == the port's graph; offsets bound each segment exactly."""
    jg = GRAPHS[kind](JG)
    tg = _port(GRAPHS[kind])
    carried = TS.from_arrays(**_leaves(jg), n_vertices=jg.n_vertices, device="cpu")
    assert (tg.n_vertices, tg.n_edges) == (jg.n_vertices, jg.n_edges)
    for g in (tg, carried):
        for k, want in _leaves(jg).items():
            got = getattr(g, k).numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        n = g.n_vertices
        for ids, ptr in ((g.dst, g.in_ptr), (g.t_src, g.out_ptr)):
            counts = np.bincount(ids.numpy()[ids.numpy() < n], minlength=n)
            np.testing.assert_array_equal(np.diff(ptr.numpy()), counts)
            assert ptr.dtype == torch.int32 and ptr[0] == 0


def test_pad_edges_and_symmetrize():
    jg = JG.erdos_renyi(30, 3.0, directed=True, weighted=True, seed=5)
    tg = TG.erdos_renyi(30, 3.0, directed=True, weighted=True, seed=5, device="cpu")
    jp, tp = JS.pad_edges(jg, jg.n_edges + 17), TS.pad_edges(tg, tg.n_edges + 17)
    for k, want in _leaves(jp).items():
        np.testing.assert_array_equal(getattr(tp, k).numpy(), want, err_msg=k)
    src, dst = np.array([0, 1, 1, 3]), np.array([1, 0, 2, 3])
    for a, b in zip(TS.symmetrize(src, dst), JS.symmetrize(src, dst)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["er_undirected", "rmat7"])
def test_degrees(kind):
    jg = GRAPHS[kind](JG)
    tg = _port(GRAPHS[kind])
    np.testing.assert_array_equal(tops.in_degrees(tg).numpy(), np.asarray(jops.in_degrees(jg)))
    np.testing.assert_array_equal(tops.out_degrees(tg).numpy(), np.asarray(jops.out_degrees(jg)))
    assert tops.in_degrees(tg).dtype == torch.int32


def _scatter_case(op, rng):
    n = 25
    if op in ("or", "and"):
        buf = rng.random(n) < 0.5
        vals = rng.random(60) < 0.5
    elif op == "prod":
        buf = rng.integers(-3, 4, n).astype(np.int32)
        vals = rng.integers(-2, 3, 60).astype(np.int32)
    else:
        buf = rng.normal(size=n).astype(np.float32)
        vals = rng.normal(size=60).astype(np.float32)
    # in range, the sentinel n, beyond, and negatives that wrap or drop
    idx = np.concatenate(
        [rng.integers(0, n, 50), [n, n + 3, -1, -2, -n, -n - 1, 10**6, -(10**6), 0, n - 1]]
    ).astype(np.int32)
    return buf, idx, vals


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("op", OPS)
def test_scatter_combine(op, masked):
    """``buffer.at[idx].op(values, mode="drop")``: [-n, -1] wraps, other
    out-of-range and masked writes drop."""
    rng = np.random.default_rng(7)
    buf, idx, vals = _scatter_case(op, rng)
    mask = rng.random(idx.shape[0]) < 0.7 if masked else None
    want = np.asarray(
        jops.scatter_combine(
            jnp.asarray(buf), jnp.asarray(idx), jnp.asarray(vals), op,
            mask=None if mask is None else jnp.asarray(mask),
        )
    )
    got = tops.scatter_combine(
        torch.from_numpy(buf), torch.from_numpy(idx), torch.from_numpy(vals), op,
        mask=None if mask is None else torch.from_numpy(mask),
    ).numpy()
    assert got.dtype == want.dtype
    if op == "sum":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_scatter_set_drops_and_wraps():
    buf = np.zeros(6, np.int32)
    idx = np.array([0, 5, 6, -1, -7, 2], np.int32)
    vals = np.array([1, 2, 3, 4, 5, 6], np.int32)
    want = np.asarray(jnp.asarray(buf).at[jnp.asarray(idx)].set(jnp.asarray(vals), mode="drop"))
    got = tops.scatter_set(torch.from_numpy(buf), torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", OPS)
def test_combine(op):
    rng = np.random.default_rng(8)
    if op in ("or", "and"):
        a, b = rng.random(30) < 0.5, rng.random(30) < 0.5
    else:
        a, b = rng.integers(-9, 9, 30).astype(np.int32), rng.integers(-9, 9, 30).astype(np.int32)
    want = np.asarray(jops.combine(op, jnp.asarray(a), jnp.asarray(b)))
    got = tops.combine(op, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int32", "bool", "float32"])
@pytest.mark.parametrize("op", OPS)
def test_combine_along_axis(op, dtype):
    rng = np.random.default_rng(9)
    x = rng.integers(-3, 4, (5, 7))
    x = x > 0 if dtype == "bool" else x.astype(dtype)
    want = np.asarray(jops.combine_along_axis(op, jnp.asarray(x), 1))
    got = tops.combine_along_axis(op, torch.from_numpy(x), 1).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, **TOL)


def test_edge_softmax():
    g = JG.erdos_renyi(40, 4.0, directed=True, seed=10)
    tg = TG.erdos_renyi(40, 4.0, directed=True, seed=10, device="cpu")
    rng = np.random.default_rng(10)
    scores = rng.normal(size=(g.n_edges, 3)).astype(np.float32)
    mask = np.asarray(g.edge_mask) & (rng.random(g.n_edges) < 0.8)
    want = jops.edge_softmax(
        jnp.asarray(scores), g.dst, g.n_vertices, mask=jnp.asarray(mask),
        indices_are_sorted=True,
    )
    got = tops.edge_softmax(
        torch.from_numpy(scores), tg.dst, tg.n_vertices, mask=torch.from_numpy(mask),
        indices_are_sorted=True, offsets=tg.in_ptr,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cuda_default_refuses_without_card():
    """Entry points default to the card and never drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TG.chain(4)


def test_to_int32_matches_xla():
    """Float → int32 as XLA converts: truncate, saturate, NaN → 0."""
    x = np.array(
        [3e10, -3e10, np.inf, -np.inf, np.nan, -3.7, 3.7, 2147483520.0, -2147483648.0],
        np.float32,
    )
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(tops.to_int32(torch.from_numpy(x)).numpy(), want)


# -- inputs at the edges of JAX's conversion and index rules --------------------


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("odd", [-4, -3, -2, -1, 4, -5])
def test_edge_softmax_reads_segments_as_jax_indexes(odd, masked):
    """``seg_max[ids]`` and ``denom[ids]`` as JAX's plain indexing reads
    them (n = 4): ``[-n, -1]`` wraps to ``id + n``, ``n`` and ``-n-1`` clamp.
    The segment reductions drop those ids, so the wrapped read can see an
    empty segment's max of 0 and a denominator of 0 (then 1e-16)."""
    rng = np.random.default_rng(30 + odd)
    n = 4
    ids = np.array([0, 1, 1, odd, 2, odd, 0], np.int32)
    scores = rng.normal(size=(ids.shape[0], 2)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 0, 1], bool) if masked else None
    want = jops.edge_softmax(
        jnp.asarray(scores), jnp.asarray(ids), n,
        mask=None if mask is None else jnp.asarray(mask),
    )
    got = tops.edge_softmax(
        torch.from_numpy(scores), torch.from_numpy(ids), n,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("value", [3e9, -3e9, np.nan], ids=["3e9", "-3e9", "nan"])
@pytest.mark.parametrize("op", ["sum", "max", "min", "set"])
def test_float_into_int32_scatter_converts_as_xla(op, value):
    """f32 values written into an int32 buffer: JAX scatters in f32 and
    converts back as XLA does (saturating, NaN as 0), so 5 + 3e9 saturates
    and an untouched 2^24 + 1 comes back rounded through f32."""
    buf = np.array([0, 5, 2**24 + 1], np.int32)
    idx = np.array([0, 1], np.int32)
    vals = np.array([value, value], np.float32)
    jb, ji, jv = jnp.asarray(buf), jnp.asarray(idx), jnp.asarray(vals)
    tb, ti, tv = torch.from_numpy(buf), torch.from_numpy(idx), torch.from_numpy(vals)
    if op == "set":
        want = jb.at[ji].set(jv, mode="drop")
        got = tops.scatter_set(tb, ti, tv)
    else:
        want = jops.scatter_combine(jb, ji, jv, op)
        got = tops.scatter_combine(tb, ti, tv, op)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("held", [np.nan, 3e9, -3e9], ids=["nan", "3e9", "-3e9"])
@pytest.mark.parametrize("op", ["or", "and"])
def test_or_and_scatter_converts_float_buffer_as_xla(op, held):
    """``||=``/``&&=`` into an f32 buffer go through int32 as XLA converts
    the buffer: a row that no write reaches comes back saturated (NaN as 0)."""
    buf = np.array([held, 0.0, 2.0], np.float32)
    idx = np.array([1, 3, 2], np.int32)  # row 0 untouched, 3 dropped
    vals = np.array([1.0, 1.0, 0.0], np.float32)
    want = jops.scatter_combine(jnp.asarray(buf), jnp.asarray(idx), jnp.asarray(vals), op)
    got = tops.scatter_combine(
        torch.from_numpy(buf), torch.from_numpy(idx), torch.from_numpy(vals), op
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fill", [np.inf, 3e9, np.nan], ids=["inf", "3e9", "nan"])
def test_fill_int32_cannot_hold_raises_as_jax(fill):
    """A fill value an int32 table cannot hold raises JAX's exception
    (``np.asarray(fill, int32)``: ``OverflowError`` or ``ValueError``), on
    the plain path and in the kernel's fill bits alike."""
    from repro_torch.kernels.gather_rows import ops as gather_ops

    table = np.array([5, 6], np.int32)
    idx = np.array([7], np.int32)
    with pytest.raises(Exception) as jax_raised:
        jops.gather(jnp.asarray(table), jnp.asarray(idx), fill)
    kind = jax_raised.type
    assert kind in (OverflowError, ValueError)
    with pytest.raises(kind):
        tops.gather(torch.from_numpy(table), torch.from_numpy(idx), fill)
    with pytest.raises(kind):
        gather_ops._fill_bits(fill, torch.int32)
