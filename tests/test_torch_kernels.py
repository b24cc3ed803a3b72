"""The port's kernel modules against the JAX package, on the CPU.

On the CPU a kernel wrapper takes its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds each one
against this same plain version). Here each plain version is held against
the JAX functions it stands for: the Pallas kernels in interpret mode,
their ``ref.py`` oracles, and ``repro.graph.ops``. The shape sweeps of
``TestGatherRows``/``TestSegmentSumEll`` in tests/test_kernels.py are
reused by value.

Tolerances: gathers and int/bool/min/max reductions are exact. Float sums
and products use ``TOL`` of tests/test_kernels.py (f32 rtol = atol = 2e-5,
bf16 3e-2), because the summation order differs between the two packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph import ops as jops  # noqa: E402
from repro.kernels.gather_rows import gather_rows_pallas  # noqa: E402
from repro.kernels.gather_rows.ref import gather_rows_ref  # noqa: E402
from repro.kernels.segment_reduce import segment_sum_ell  # noqa: E402
from repro.kernels.segment_reduce.ref import segment_sum_ref  # noqa: E402
from repro_torch.graph import ops as tops  # noqa: E402
from repro_torch.graph.structure import segment_offsets  # noqa: E402
from repro_torch.kernels import gather_rows, segment_reduce  # noqa: E402
from repro_torch.kernels.segment_reduce import identity  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32, "bool": jnp.bool_}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32, "bool": torch.bool}


def _both(x: np.ndarray, dtype: str):
    """The same values in both packages (bf16 rounds the same way in both)."""
    return jnp.asarray(x).astype(JNP[dtype]), torch.from_numpy(np.array(x)).to(TORCH[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


# -- gather_rows ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("v,d,n", [(64, 16, 32), (500, 100, 7)])
def test_gather_rows_sweep(dtype, v, d, n):
    """TestGatherRows' sweep: plain version == Pallas (interpret) == ref."""
    rng = np.random.default_rng(3)
    jtable, ttable = _both(rng.integers(-5, 5, (v, d)), dtype)
    idx = rng.integers(0, v, n).astype(np.int32)
    out = gather_rows(ttable, torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(out), _np(gather_rows_ref(jtable, jnp.asarray(idx))))
    np.testing.assert_array_equal(
        _np(out), _np(gather_rows_pallas(jtable, jnp.asarray(idx), interpret=True))
    )


@pytest.mark.parametrize("fill", [None, "value"], ids=["clip", "fill"])
@pytest.mark.parametrize("width", [None, 3], ids=["rows", "rows3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "bool"])
def test_gather_index_modes(dtype, width, fill):
    """``ops.gather`` == ``repro.graph.ops.gather`` on negative indices
    (clip: −1 reads row 0; fill: [-V, -1] wraps), below −V, the sentinel
    V and beyond."""
    rng = np.random.default_rng(11)
    v = 37
    shape = (v,) if width is None else (v, width)
    raw = rng.integers(-50, 50, shape)
    jfield, tfield = _both(raw > 0 if dtype == "bool" else raw, dtype)
    idx = np.concatenate(
        [rng.integers(0, v, 40), [-1, -2, -v, -v - 1, -200, v, v + 1, 10**6, 0, v - 1]]
    ).astype(np.int32)
    fill_value = None if fill is None else {"bool": False}.get(dtype, -7)
    got = tops.gather(tfield, torch.from_numpy(idx), fill_value)
    want = jops.gather(jfield, jnp.asarray(idx), fill_value)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gather_chain_composition():
    """gather(gather) == pull-mode chain evaluation (D²), as the Pallas
    kernel composes it."""
    rng = np.random.default_rng(4)
    n = 64
    D = rng.integers(0, n, n).astype(np.int32)
    table = rng.normal(size=(n, 128)).astype(np.float32)
    td = torch.from_numpy(D)
    got = gather_rows(gather_rows(torch.from_numpy(table), td), td)
    via_pallas = gather_rows_pallas(
        gather_rows_pallas(jnp.asarray(table), jnp.asarray(D), interpret=True),
        jnp.asarray(D), interpret=True,
    )
    np.testing.assert_array_equal(got.numpy(), table[D[D]])
    np.testing.assert_array_equal(got.numpy(), np.asarray(via_pallas))


# -- segment_reduce ------------------------------------------------------------

#: combiners each dtype takes in the JAX package (bool sum/prod raise there)
CASES = [
    (op, dtype)
    for dtype in ("float32", "int32", "bool")
    for op in ("sum", "prod", "min", "max", "or", "and")
    if not (dtype == "bool" and op in ("sum", "prod"))
]


def _values(rng, dtype, shape, op):
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype == "int32":
        hi = 3 if op == "prod" else 1000
        return rng.integers(-hi, hi + 1, shape).astype(np.int32)
    scale = 0.5 if op == "prod" else 10.0
    return (rng.normal(size=shape) * scale + (1.0 if op == "prod" else 0.0)).astype(
        np.float32
    )


@pytest.mark.parametrize("width", [None, 4], ids=["rows", "rows4"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("op,dtype", CASES)
def test_segment_reduce_vs_jax(op, dtype, masked, width):
    """``ops.segment_reduce`` == ``repro.graph.ops.segment_reduce`` over
    sorted ids with empty segments, dropped ids (−1 and the sentinel n) and
    a mask; empty or fully masked segments get the identity."""
    rng = np.random.default_rng(12)
    n, e = 40, 300
    ids = np.sort(
        np.concatenate([rng.integers(0, n, e - 20), np.full(8, -1), np.full(12, n)])
    ).astype(np.int32)
    ids[(ids >= 10) & (ids < 14)] = 15  # segments 10..13 empty
    ids = np.sort(ids)
    shape = (e,) if width is None else (e, width)
    jvals, tvals = _both(_values(rng, dtype, shape, op), dtype)
    mask = rng.random(e) < 0.8 if masked else None
    tids = torch.from_numpy(ids)

    def port():
        return tops.segment_reduce(
            tvals, tids, n, op, indices_are_sorted=True,
            mask=None if mask is None else torch.from_numpy(mask),
            offsets=segment_offsets(tids, n),
        )

    try:
        want = jops.segment_reduce(
            jvals, jnp.asarray(ids), n, op, indices_are_sorted=True,
            mask=None if mask is None else jnp.asarray(mask),
        )
    except KeyError:  # masked or/and on ints: no identity in the JAX table
        with pytest.raises(KeyError):
            port()
        return
    got = port()
    assert tuple(got.shape) == want.shape and _np(got).dtype == _np(want).dtype
    if dtype == "float32" and op in ("sum", "prod"):
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


def test_int32_sum_wraps():
    """An int32 segment sum wraps in two's complement, as XLA's does."""
    vals = np.array([2**31 - 1, 5, -(2**31), -1], np.int32)
    ids = np.array([0, 0, 1, 1], np.int32)
    want = jops.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), 2, "sum")
    got = tops.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), 2, "sum")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["sum", "prod", "min", "max"])
def test_float_nan_propagates(op):
    """A NaN on an unmasked edge makes its segment NaN for every combiner,
    min and max included, as XLA's do; a masked NaN is ignored."""
    vals = np.array([1.0, np.nan, 3.0, 2.0, np.nan, 5.0, -1.0], np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2, 3], np.int32)
    mask = np.array([1, 1, 1, 1, 0, 1, 1], bool)
    want = jops.segment_reduce(
        jnp.asarray(vals), jnp.asarray(ids), 5, op, mask=jnp.asarray(mask)
    )
    got = tops.segment_reduce(
        torch.from_numpy(vals), torch.from_numpy(ids), 5, op,
        mask=torch.from_numpy(mask), offsets=segment_offsets(torch.from_numpy(ids), 5),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isnan(got.numpy()[0]) and not np.isnan(got.numpy()[1:]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "bool"])
@pytest.mark.parametrize("op", ["sum", "prod", "min", "max", "or", "and"])
def test_identity_table(op, dtype):
    """The identity each combiner gives an empty segment == the JAX table."""
    try:
        want = jops._identity_for(op, JNP[dtype])
    except KeyError:
        with pytest.raises(KeyError):
            identity(op, TORCH[dtype])
        return
    got = identity(op, TORCH[dtype])
    assert _np(want).item() == got and type(got) is type(_np(want).item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "e,n,d,nb,eb,cap",
    [
        (500, 100, 16, 32, 32, None),
        (2000, 300, 64, 64, 64, None),
        (1000, 50, 8, 16, 16, 64),  # forced spill path
        (64, 9, 128, 8, 8, None),
    ],
)
def test_segment_sum_vs_ell_kernel(dtype, e, n, d, nb, eb, cap):
    """TestSegmentSumEll's sweep: the plain masked segment sum (f32
    accumulation, input dtype out, as the Pallas kernel) == the Pallas
    kernel in interpret mode, spill included, and == the f32 oracle."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, n, e).astype(np.int32)
    jvals, tvals = _both(rng.normal(size=(e, d)), dtype)
    mask = rng.random(e) < 0.9
    ell = segment_sum_ell(
        jvals, jnp.asarray(ids), n, mask=jnp.asarray(mask), nb=nb, eb=eb,
        budget_cap=cap, interpret=True,
    )
    ref = segment_sum_ref(jvals.astype(jnp.float32), jnp.asarray(ids), n, mask=jnp.asarray(mask))
    order = np.argsort(ids, kind="stable")  # the kernel's contract: sorted ids
    sids = torch.from_numpy(ids[order])
    got = segment_reduce(
        tvals[torch.from_numpy(order)], sids, n, "sum",
        mask=torch.from_numpy(mask[order]), offsets=segment_offsets(sids, n),
    )
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_np(got), _np(ell), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])
