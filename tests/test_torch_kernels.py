"""The port's kernel modules against the JAX package, on the CPU.

On the CPU a kernel wrapper takes its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds each one
against this same plain version). Here each plain version is held against
the JAX functions it stands for: the Pallas kernels in interpret mode,
their ``ref.py`` oracles, and ``repro.graph.ops``. The shape sweeps of
``TestGatherRows``/``TestSegmentSumEll``/``TestFlashAttention``/
``TestEmbeddingBag`` in tests/test_kernels.py are reused by value.

Tolerances: gathers and int/bool/min/max reductions are exact. Float sums
and products use ``TOL`` of tests/test_kernels.py (f32 rtol = atol = 2e-5,
bf16 3e-2), because the summation order differs between the two packages.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph import ops as jops  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag_pallas  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.gather_rows import gather_rows_pallas  # noqa: E402
from repro.kernels.gather_rows.ref import gather_rows_ref  # noqa: E402
from repro.kernels.segment_reduce import segment_sum_ell  # noqa: E402
from repro.kernels.segment_reduce.ref import segment_sum_ref  # noqa: E402
from repro_torch.graph import ops as tops  # noqa: E402
from repro_torch.graph.structure import segment_offsets  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    embedding_bag,
    flash_attention,
    gather_rows,
    segment_reduce,
)
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


# -- flash_attention -----------------------------------------------------------

FLASH_SWEEP = [  # TestFlashAttention's shapes: b, h, hkv, sq, sk, d, causal, window
    (2, 4, 2, 64, 64, 32, True, None),
    (1, 2, 2, 48, 80, 16, True, 16),
    (2, 8, 4, 33, 57, 64, False, None),
    (1, 4, 1, 128, 128, 128, True, 32),
    (1, 1, 1, 8, 256, 64, True, None),
]


def _qkv(rng, dtype, b, h, hkv, sq, sk, d):
    return (
        _both(rng.normal(size=(b, h, sq, d)), dtype),
        _both(rng.normal(size=(b, hkv, sk, d)), dtype),
        _both(rng.normal(size=(b, hkv, sk, d)), dtype),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", FLASH_SWEEP)
def test_flash_attention_sweep(dtype, b, h, hkv, sq, sk, d, causal, window):
    """TestFlashAttention's sweep: the plain version == the Pallas kernel
    (interpret mode) and == ``attention_ref`` on the f32 inputs, at TOL."""
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, dtype, b, h, hkv, sq, sk, d)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (b, h, sq, d)
    pallas = jflash(jq, jk, jv, causal=causal, window=window,
                    block_q=32, block_k=32, interpret=True)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    ref = attention_ref(f32(jq), f32(jk), f32(jv), causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, 9)])
def test_flash_attention_scale(causal, window):
    """``scale`` multiplies the f32 scores: equal to the reference on
    ``q · scale`` in f32 (the model passes ``Dh**-0.5``)."""
    rng = np.random.default_rng(6)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, "float32", 2, 4, 2, 70, 70, 16)
    scale = 16**-0.5
    got = flash_attention(tq, tk, tv, causal=causal, window=window, scale=scale)
    ref = attention_ref(jq * scale, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL["float32"])


def test_flash_attention_row_without_keys():
    """A query row that keeps no key (window past the last key) gives 0,
    as ``attention_ref`` does."""
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, "float32", 1, 2, 1, 100, 10, 8)
    got = flash_attention(tq, tk, tv, causal=False, window=5)
    ref = attention_ref(jq, jk, jv, causal=False, window=5)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL["float32"])
    assert not _np(got)[:, :, 20:].any()


def _chip_smoke():
    """``chip_smoke.py`` at the root of the repo, imported as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flash_row_check_sees_one_tile():
    """The smoke's row-by-row flash check, in the prefill's regime (D = 80,
    scores of unit spread, a window of 1024 keys, bf16, so each
    row's output is small): it passes the Pallas kernel (interpret mode)
    against the port's plain version, and fails the plain version with the
    window cut by one 64-key tile."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(8)
    d, s, window = 80, 1152, 1024
    q = rng.normal(size=(1, 2, s, d)) * d**-0.5
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(q, "bfloat16"),
        _both(rng.normal(size=(1, 1, s, d)), "bfloat16"),
        _both(rng.normal(size=(1, 1, s, d)), "bfloat16"),
    )
    want = flash_attention(tq, tk, tv, causal=True, window=window)
    pallas = jflash(jq, jk, jv, causal=True, window=window,
                    block_q=64, block_k=64, interpret=True)
    got = torch.from_numpy(np.asarray(pallas.astype(jnp.float32))).to(torch.bfloat16)
    assert smoke.flash_row_check(got, want, "pallas") < smoke.FLASH_ROW[torch.bfloat16][0]
    cut = flash_attention(tq, tk, tv, causal=True, window=window - 64)
    worst, _ = smoke.flash_rows(cut, want)
    assert worst > 1.0
    with pytest.raises(AssertionError):
        smoke.flash_row_check(cut, want, "window cut by 64 keys")


from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route_rule(dtype):
    """The kernel's route depends on dtype and D alone: bf16 with D % 8 == 0
    runs on the tensor cores (TMA rows of 16-byte multiples), everything
    else, f32 above all (wgmma would be TF32), on the SIMT kernel."""
    for d in range(1, 129):
        want = "tc" if dtype == torch.bfloat16 and d % 8 == 0 else "simt"
        assert flash_ops.route(dtype, d) == want, d
    assert flash_ops.route(torch.bfloat16, 80) == "tc"  # the model's heads
    assert flash_ops.route(torch.bfloat16, 100) == "simt"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_route_rule(dtype):
    """The backward's route depends on dtype and D alone, the forward's
    rule: bf16 with D % 8 == 0 takes the tensor cores (TMA rows of 16-byte
    multiples; D rounded up to 16 inside), everything else the f32 units."""
    for d in range(1, 129):
        want = "tc" if dtype == torch.bfloat16 and d % 8 == 0 else "simt"
        assert flash_ops.bwd_route(dtype, d) == want, d
        assert flash_ops.bwd_route(dtype, d) == flash_ops.route(dtype, d), d
    assert flash_ops.bwd_route(torch.bfloat16, 80) == "tc"  # h2o-danube's heads
    assert flash_ops.bwd_route(torch.bfloat16, 128) == "tc"  # deepseek-moe's
    assert flash_ops.bwd_route(torch.bfloat16, 8) == "tc"
    assert flash_ops.bwd_route(torch.bfloat16, 100) == "simt"


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", FLASH_SWEEP)
def test_flash_lse_of_rounded_scores(b, h, hkv, sq, sk, d, causal, window):
    """With ``round_scores`` and bf16 inputs the forward's logsumexp is the
    log-sum-exp of the kept scores rounded once to bf16 before the scale
    (JAX's ``einsum(bf16).astype(f32) * scale``), at f32's TOL; at scale 1
    it differs from the unrounded one by more than that; the plain
    backward is the same with the scores so rounded (against a float64
    reference of it, at bf16's TOL scaled by the largest gradient); and
    for f32 inputs the flag changes no bit."""
    rng = np.random.default_rng(10)
    (_, tq), (_, tk), (_, tv) = _qkv(rng, "bfloat16", b, h, hkv, sq, sk, d)
    scale = d**-0.5
    out, lse = flash_ops.flash_attention(tq, tk, tv, causal, window, scale,
                                         return_lse=True, round_scores=True)
    keep = flash_ops.keep_mask(torch.arange(sq), torch.arange(sk), causal, window).numpy()
    kr = np.repeat(_np(tk), h // hkv, axis=1).astype(np.float64)
    raw = np.einsum("bhqd,bhkd->bhqk", _np(tq).astype(np.float64), kr)
    rounded = torch.from_numpy(raw).to(torch.bfloat16).double().numpy()
    with np.errstate(divide="ignore"):
        want = np.logaddexp.reduce(np.where(keep, rounded * scale, -np.inf), axis=-1)
        unrounded = np.logaddexp.reduce(np.where(keep, raw, -np.inf), axis=-1)
    want = np.where(np.isneginf(want), np.inf, want)
    np.testing.assert_allclose(_np(lse), want, **TOL["float32"])
    _, lse1 = flash_ops.flash_attention(tq, tk, tv, causal, window, 1.0, return_lse=True,
                                        round_scores=True)
    ok = np.isfinite(unrounded)
    assert np.abs(_np(lse1)[ok] - unrounded[ok]).max() > 10 * TOL["float32"]["atol"]
    # the backward recomputes P from the rounded scores
    do = torch.from_numpy(rng.normal(size=(b, h, sq, d))).to(torch.bfloat16)
    got = flash_ops.flash_attention_bwd(tq, tk, tv, out, lse, do, causal, window, scale,
                                        round_scores=True)
    vr = np.repeat(_np(tv), h // hkv, axis=1).astype(np.float64)
    p = np.where(keep, np.exp(rounded * scale - _np(lse)[..., None].astype(np.float64)), 0.0)
    d_o = _np(do).astype(np.float64)
    delta = (d_o * _np(out).astype(np.float64)).sum(-1)
    ds = p * (np.einsum("bhqd,bhkd->bhqk", d_o, vr) - delta[..., None]) * scale
    fold = lambda x: x.reshape(b, hkv, h // hkv, *x.shape[2:]).sum(2)  # noqa: E731
    wants = (np.einsum("bhqk,bhkd->bhqd", ds, kr),
             fold(np.einsum("bhqk,bhqd->bhkd", ds, _np(tq).astype(np.float64))),
             fold(np.einsum("bhqk,bhqd->bhkd", p, d_o)))
    for g_, w_ in zip(got, wants):
        tol = TOL["bfloat16"]["rtol"]
        np.testing.assert_allclose(_np(g_), w_, rtol=tol,
                                   atol=tol * max(float(np.abs(w_).max()), 1e-30))
    (_, fq), (_, fk), (_, fv) = _qkv(rng, "float32", b, h, hkv, sq, sk, d)
    plain = flash_ops.flash_attention(fq, fk, fv, causal, window, scale, return_lse=True)
    flagged = flash_ops.flash_attention(fq, fk, fv, causal, window, scale, return_lse=True,
                                        round_scores=True)
    assert all(torch.equal(x, y) for x, y in zip(plain, flagged))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (True, 64),
                                           (False, None), (False, 200), (True, 1)])
@pytest.mark.parametrize("sq,sk", [(1, 1), (63, 63), (64, 129), (300, 300), (257, 100),
                                   (100, 400)])
def test_flash_bwd_schedule(causal, window, sq, sk):
    """The tensor-core backward's walk (``bwd_schedule``, the loops of
    ``csrc/flash_attention_bwd.cu``), with GQA (4 query heads on 2 kv heads,
    batch 2):

    * every pair ``keep_mask`` keeps is visited exactly once, by the block
      of its key tile and its kv head, in a step of its query head;
    * a block waits only on blocks of a smaller ``blockIdx`` (launched
      before it), and run in any order that honours the waits, with at
      most a few blocks resident at once and launched in ``blockIdx``
      order, every block finishes and the dQ adds into each query tile
      come in ascending key-tile order, the first of them a store;
    * a query tile with no block adding into it is one that keeps no key
      (``dq_kernel`` writes its 0)."""
    b, h, hkv = 2, 4, 2
    bq, bk = flash_ops.BWD_BLOCK_Q, flash_ops.BWD_BLOCK_K
    keep = flash_ops.keep_mask(torch.arange(sq), torch.arange(sk), causal, window).numpy()
    sched = flash_ops.bwd_schedule(b, h, hkv, sq, sk, causal, window)
    assert [blk for blk, _, _ in sched] == list(range(len(sched)))
    visits = np.zeros((b * h, sq, sk), dtype=np.int64)
    adders = {}  # (bh, qt) -> key tiles in the order they must add
    for blk, kt, steps in sched:
        kv = blk % (b * hkv)
        for bh, qt, before in steps:
            assert (bh // h) * hkv + (bh % h) // (h // hkv) == kv
            visits[bh, qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk] += 1
            adders.setdefault((bh, qt), []).append(kt)
    assert visits.max() <= 1
    assert not (np.broadcast_to(keep, visits.shape) & (visits == 0)).any()
    for (bh, qt), kts in adders.items():
        first, end = flash_ops.bwd_key_tiles(qt, sk, causal, window)
        assert sorted(kts) == list(range(first, end)), (bh, qt)
    for qt in range(-(-sq // bq)):
        first, end = flash_ops.bwd_key_tiles(qt, sk, causal, window)
        if first >= end:
            assert not keep[qt * bq:(qt + 1) * bq].any()
    # a block waits (on its tile's counter) only for blocks launched before it
    owner = {(bh, qt, kt - flash_ops.bwd_key_tiles(qt, sk, causal, window)[0]): blk
             for blk, kt, steps in sched for bh, qt, _ in steps}
    for blk, kt, steps in sched:
        for bh, qt, before in steps:
            if before:
                assert owner[(bh, qt, before - 1)] < blk
    # run the blocks, launched in blockIdx order as residency frees up; a
    # step runs once `before` adds have reached its tile
    n = len(sched)
    for seed, resident in ((0, 1), (1, 3), (2, n)):
        order = np.random.default_rng(seed)
        pos, count, added, launched = [0] * n, {}, {}, 0
        while True:
            live = sum(pos[i] < len(sched[i][2]) for i in range(launched))
            while launched < n and live < resident:
                live += len(sched[launched][2]) > 0
                launched += 1
            ready = [i for i in range(launched) if pos[i] < len(sched[i][2])
                     and count.get(sched[i][2][pos[i]][:2], 0) == sched[i][2][pos[i]][2]]
            if not ready:
                break
            i = ready[order.integers(len(ready))]
            bh, qt, before = sched[i][2][pos[i]]
            added.setdefault((bh, qt), []).append(sched[i][1])
            count[(bh, qt)] = before + 1
            pos[i] += 1
        assert launched == n and all(p == len(st) for p, (_, _, st) in zip(pos, sched)), \
            "the waits deadlock"
        assert added == {key: sorted(kts) for key, kts in adders.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", FLASH_SWEEP)
def test_flash_lse_and_bwd_sweep(dtype, b, h, hkv, sq, sk, d, causal, window):
    """Over TestFlashAttention's sweep: the forward's logsumexp is the
    log-sum-exp of the reference's kept scores (+inf where a row keeps
    none, so its P is 0), the output is the same with or without it, and
    the plain backward equals ``jax.vjp`` of ``attention_ref`` on the f32
    inputs at TOL (scaled by the largest gradient: sums over keys)."""
    rng = np.random.default_rng(9)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, dtype, b, h, hkv, sq, sk, d)
    out, lse = flash_ops.flash_attention(tq, tk, tv, causal, window, 1.0, return_lse=True)
    assert torch.equal(out, flash_attention(tq, tk, tv, causal=causal, window=window))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, sq)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    keep = flash_ops.keep_mask(torch.arange(sq), torch.arange(sk), causal, window)
    s = np.einsum("bhqd,bhkd->bhqk", _np(tq), np.repeat(_np(tk), h // hkv, axis=1))
    s = np.where(keep.numpy(), s.astype(np.float64), -np.inf)
    with np.errstate(divide="ignore"):
        want_lse = np.logaddexp.reduce(s, axis=-1)
    want_lse = np.where(np.isneginf(want_lse), np.inf, want_lse)
    np.testing.assert_allclose(_np(lse), want_lse, **TOL["float32"])
    dout = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    tdo = torch.from_numpy(dout).to(TORCH[dtype])
    got = flash_ops.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, window, 1.0)
    _, vjp = jax.vjp(lambda q_, k_, v_: attention_ref(q_, k_, v_, causal=causal,
                                                      window=window),
                     f32(jq), f32(jk), f32(jv))
    for g_, w_ in zip(got, vjp(f32(jnp.asarray(_np(tdo))))):
        w_ = np.asarray(w_)
        assert g_.dtype == TORCH[dtype]
        tol = TOL[dtype]["rtol"]
        np.testing.assert_allclose(_np(g_), w_, rtol=tol,
                                   atol=tol * max(float(np.abs(w_).max()), 1e-30))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 127, 128, 129, 200, 1000])
def test_flash_live_tiles_cover_kept_pairs(causal, window):
    """The tensor-core kernel's loop ranges at its 128 x 128 tiles: every
    pair ``keep_mask`` keeps lies in a visited (query tile, key tile); a
    visited tile with no kept pair among the real rows and keys is one the
    TPU kernel's block rule (``kernel.py``'s ``live``) visits too; and a
    tile the kernel leaves unmasked keeps every pair of its warpgroup's
    real rows."""
    bq, bk = flash_ops.TC_BLOCK_Q, flash_ops.TC_BLOCK_K
    for sq in (1, 127, 128, 129, 300):
        for sk in (1, 127, 128, 129, 300):
            keep = flash_ops.keep_mask(torch.arange(sq), torch.arange(sk), causal, window)
            visited = torch.zeros_like(keep)
            for qt, begin, end in flash_ops.live_tiles(sq, sk, causal, window):
                q0 = qt * bq
                for kt in range(begin, end):
                    k0 = kt * bk
                    tile = keep[q0:q0 + bq, k0:k0 + bk]
                    visited[q0:q0 + bq, k0:k0 + bk] = True
                    if not tile.any():  # allowed only where the TPU rule is live
                        assert not causal or k0 <= q0 + bq - 1
                        assert window is None or k0 + bk - 1 >= q0 - window + 1
                    for lo in (q0, q0 + 64):  # one warpgroup's 64 rows each
                        rows = keep[lo:lo + 64, k0:k0 + bk]
                        if rows.numel() and not flash_ops.tile_needs_mask(
                                lo, 64, k0, sk, causal, window):
                            assert k0 + bk <= sk and rows.all(), (sq, sk, qt, kt, lo)
            assert not (keep & ~visited).any(), (sq, sk)


# -- embedding_bag -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,d,b,h", [(100, 16, 8, 4), (1000, 64, 16, 1), (50, 128, 4, 10)])
def test_embedding_bag_sweep(dtype, v, d, b, h):
    """TestEmbeddingBag's sweep: the plain version with weights and mask ==
    the Pallas kernel (interpret mode) and == ``embedding_bag_ref``."""
    rng = np.random.default_rng(2)
    jt, tt = _both(rng.normal(size=(v, d)), dtype)
    idx = rng.integers(0, v, (b, h)).astype(np.int32)
    jw, tw = _both(rng.normal(size=(b, h)), dtype)
    mask = rng.random((b, h)) < 0.8
    got = embedding_bag(tt, torch.from_numpy(idx), tw, torch.from_numpy(mask))
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (b, d)
    pallas = embedding_bag_pallas(jt, jnp.asarray(idx), weights=jw,
                                  mask=jnp.asarray(mask), interpret=True)
    ref = embedding_bag_ref(jt.astype(jnp.float32), jnp.asarray(idx),
                            jw.astype(jnp.float32) * mask)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weights"])
def test_embedding_bag_clips_ids(weighted):
    """Ids below 0 and at or past V read the first and last rows, as
    ``embedding_bag_ref`` (``take(mode="clip")``) does; weights default to 1."""
    rng = np.random.default_rng(8)
    v, d = 30, 8
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = np.array([[-1, 0, v], [v + 7, -(2**31), 2**31 - 1], [3, 4, 5]], np.int32)
    w = rng.normal(size=idx.shape).astype(np.float32) if weighted else None
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                        None if w is None else torch.from_numpy(w))
    ref = embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                            jnp.ones(idx.shape) if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL["float32"])


def _table_view(values: np.ndarray, dtype: str, offset: int):
    """``values`` [V, D] as a contiguous view ``offset`` elements into its
    storage (a misaligned table pointer for offsets 1-3)."""
    v, d = values.shape
    flat = np.concatenate([np.zeros(offset), values.reshape(-1)])
    base = torch.from_numpy(flat).to(TORCH[dtype])
    table = base[offset:].view(v, d)
    assert table.is_contiguous() and table.data_ptr() - base.data_ptr() == offset * base.element_size()
    return table


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weights"])
@pytest.mark.parametrize("dtype,v,d,b,h,offset",
                         [case[:6] for case in _chip_smoke().BAG_SWEEP])
def test_embedding_bag_route_shapes(dtype, v, d, b, h, offset, weighted):
    """The plain version at the card sweep's shapes (``chip_smoke.py``'s
    ``BAG_SWEEP``, less the route each case must take on the card: odd D,
    table views at storage offsets 1-3, H = 0, weighted bf16 bags of 8,
    rows wider than a block) against the Pallas
    kernel (interpret mode; it has no H = 0, so there against the ref alone)
    and ``embedding_bag_ref``: exact for H <= 1, else ``TOL``."""
    rng = np.random.default_rng(40 + d + h + offset)
    values = rng.normal(size=(v, d))
    jt = jnp.asarray(values).astype(JNP[dtype])
    tt = _table_view(values, dtype, offset)
    idx = rng.integers(0, v, (b, h)).astype(np.int32)
    jw, tw = _both(rng.normal(size=(b, h)), dtype) if weighted else (None, None)
    mask = rng.random((b, h)) < 0.8 if weighted else None
    got = embedding_bag(tt, torch.from_numpy(idx), tw,
                        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (b, d)
    w = jw * jnp.asarray(mask).astype(JNP[dtype]) if weighted else jnp.ones((b, h), JNP[dtype])
    wants = [embedding_bag_ref(jt, jnp.asarray(idx), w)]
    if h:
        wants.append(embedding_bag_pallas(jt, jnp.asarray(idx), weights=jw,
                                          mask=None if mask is None else jnp.asarray(mask),
                                          interpret=True))
    for want in wants:
        if h <= 1:
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# -- the redesigned graph kernels: gather_rows' routes, segment_reduce's tiles --

import pathlib  # noqa: E402
import re  # noqa: E402

from repro_torch.kernels.gather_rows import ops as gather_ops  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as seg_ops  # noqa: E402


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 1003])
def test_gather_route_rule(offset, n):
    """The route depends on the row length alone: rows of one element (1 or
    4 bytes) take the vec route, wider rows (5·4, 40·4, 75·2 and 602·4
    bytes) the scalar route, whatever N, the ``idx`` view's storage offset
    and, for the wider rows, the table view's storage offset (``offset``
    elements: a table off 16-byte alignment, so a narrower access). Both
    compute the rows ``repro.graph.ops.gather`` computes on the same ``idx``
    view, in clip and fill mode (here through the plain version)."""
    rng = np.random.default_rng(23)
    base_np = rng.integers(-100, 100, 1100).astype(np.int32)
    base = torch.from_numpy(base_np)
    idx = base[offset:offset + n]
    assert idx.data_ptr() - base.data_ptr() == 4 * offset
    jidx = jnp.asarray(base_np[offset:offset + n])
    for dtype, shape in (("bool", (97,)), ("int32", (97,)), ("float32", (97, 5)),
                         ("float32", (97, 40)), ("bfloat16", (97, 75)),
                         ("float32", (97, 602))):
        table_np = _values(rng, dtype, shape, "sum")
        jtable, table = _both(table_np, dtype)
        if len(shape) > 1:  # the same rows as a view ``offset`` elements into its storage
            table = _table_view(table_np, dtype, offset)
        row_len = int(np.prod(shape[1:], dtype=np.int64))
        assert gather_ops.route(row_len) == ("vec" if row_len == 1 else "scalar")
        for fill in (None, False if dtype == "bool" else 7):
            want = jops.gather(jtable, jidx, fill)
            np.testing.assert_array_equal(_np(gather_rows(table, idx, fill)), _np(want))


@pytest.mark.parametrize("table_offset", range(16))
def test_gather_access_rule(table_offset):
    """The scalar route's access width (``ops.access_bytes``, the C entry's
    rule) over row bytes 2 to 4,096 and table and output addresses 0 to 15
    bytes past a 16-byte boundary: it divides the row's bytes and both
    addresses, and no wider access of 16, 8, 4, 2 does. The rows the model
    shapes take: SAGE's 400-byte and GraphCast's 1,024-byte rows 16 bytes,
    PNA's 200-byte and the minibatch's 2,408-byte rows 8."""
    for row_bytes in range(2, 4097):
        for out_offset in range(16):
            t, o = 4096 + table_offset, 8192 + out_offset
            a = gather_ops.access_bytes(row_bytes, t, o)
            assert row_bytes % a == 0 and t % a == 0 and o % a == 0
            assert all(row_bytes % w or t % w or o % w for w in (16, 8, 4, 2) if w > a)
    for row_bytes, want in ((400, 16), (1024, 16), (200, 8), (2408, 8), (150, 2), (3, 1)):
        assert gather_ops.access_bytes(row_bytes, 256, 512) == want


# The rows route's tiling in plain PyTorch, as csrc/segment_reduce.cu cuts
# the merge items (rows + segment ends) into tiles of ``tile_items``.


def merge_tiles(offsets: torch.Tensor, tile_items: int):
    """The rows route's tiles over CSR ``offsets [n + 1]``: a list of
    ``(first_segment, end_segment, row_begin, row_end)``, one per tile.
    The items are the rows ``[offsets[0], offsets[n])`` and the ``n``
    segment ends, merged in order (a segment's end follows its last row);
    tile ``k`` is items ``[k * tile_items, (k + 1) * tile_items)``, and
    holds the ends of segments ``[first_segment, end_segment)`` and the rows
    ``[row_begin, row_end)``. ``first_segment`` is the merge-path split the
    kernel's ``seg_search`` finds by binary search."""
    off = offsets.long().cpu()
    n = off.shape[0] - 1
    r0 = int(off[0])
    total = int(off[n]) - r0 + n
    # the end item of segment s sits at (offsets[s+1] - r0) + s, increasing
    end_pos = off[1:] - r0 + torch.arange(n)
    edges = torch.arange(0, total + tile_items, tile_items).clamp(max=total)
    split = torch.searchsorted(end_pos, edges, side="left").tolist()
    edges = edges.tolist()
    return [
        (split[k], split[k + 1], r0 + edges[k] - split[k], r0 + edges[k + 1] - split[k + 1])
        for k in range(len(edges) - 1)
    ]


def segment_reduce_tiled(values, offsets, op, mask, tile_items):
    """Both routes' arithmetic, tile by tile: returns ``(out, tiles)``.
    Within a tile, a segment that ends there gets the fold of its rows in
    the tile; the one it starts with, if an earlier tile holds rows of it,
    leaves that fold as the tile's ``head`` partial; the segment open at the
    tile's end leaves the fold of its rows in the tile as the tile's
    ``carry``. Then each run of tiles that carry one segment is folded in
    tile order, followed by the head partial of the tile that ends the
    segment. ``tiles`` lists, per tile, ``(first_segment, end_segment,
    row_begin, row_end, carry_segment or None, has_head)``. Rows of one
    element (the rows route) or of W (the cols route: W-wide partials, heads
    and carries); masked rows fold as the identity; bf16 folds in f32."""
    n = offsets.shape[0] - 1
    ident = identity(op, values.dtype)
    work = values.float() if values.dtype == torch.bfloat16 else values
    if mask is not None:
        work = torch.where(mask.reshape((-1,) + (1,) * (work.ndim - 1)), work, ident)
    off = offsets.long().tolist()
    empty = torch.full(work.shape[1:], ident, dtype=work.dtype)

    def fold(rows):  # one partial over rows, in the plain version's arithmetic
        if rows.shape[0] == 0:
            return empty
        ids = torch.zeros(rows.shape[0], dtype=torch.int32)
        return seg_ops.segment_reduce_plain(rows, ids, 1, op)[0]

    out = torch.full((n,) + work.shape[1:], ident, dtype=work.dtype)
    carry, head, tiles = {}, {}, []
    for k, (s0, s1, rb, re_) in enumerate(merge_tiles(offsets, tile_items)):
        for s in range(s0, s1):  # segments that end in this tile
            if s == s0 and rb > off[s0]:
                head[k] = fold(work[rb:off[s + 1]])
            elif off[s + 1] > off[s]:
                out[s] = fold(work[off[s]:off[s + 1]])
        carried = s1 < n and re_ > off[s1]
        if carried:
            carry[k] = (s1, fold(work[max(off[s1], rb):re_]))
        tiles.append((s0, s1, rb, re_, s1 if carried else None, k in head))
    for k in sorted(carry):
        s, acc = carry[k]
        if k - 1 in carry and carry[k - 1][0] == s:
            continue  # not the first tile of its run
        m = k + 1
        while m in carry and carry[m][0] == s:
            acc = fold(torch.stack([acc, carry[m][1]]))
            m += 1
        out[s] = fold(torch.stack([acc, head[m]]))
    return out.to(values.dtype), tiles


def _kernel_constants() -> dict:
    """The ``constexpr int k...`` tile constants of csrc/segment_reduce.cu."""
    src = (pathlib.Path(seg_ops.__file__).parents[2] / "csrc" / "segment_reduce.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _kernel_tile_items() -> int:
    """``kTile = kThreads * kItems`` as csrc/segment_reduce.cu sets it."""
    consts = _kernel_constants()
    return consts["kThreads"] * consts["kItems"]


def _cols_tiling(width: int, elem: int) -> tuple:
    """``(chunk_items, tile_items)`` of the cols route for rows of ``width``
    elements of ``elem`` bytes, as ``cols_geom`` of csrc/segment_reduce.cu
    sizes them: ``lanes`` threads across at most ``kColsSlice`` columns (a
    power of two up to 32), ``kThreads / lanes`` row groups, a chunk of as
    many items as ``kColsChunkBytes`` of staged rows hold (at most
    ``kColsMaxChunkItems``, a multiple of the groups, at least one a group),
    ``kColsChunks`` chunks a tile."""
    c = _kernel_constants()
    slice_ = min(width, c["kColsSlice"])
    lanes = 32 if slice_ > 32 else 1 << (slice_ - 1).bit_length()
    groups = c["kThreads"] // lanes
    rstride = width * elem if width <= slice_ else slice_ * elem + 16
    items = min(c["kColsChunkBytes"] // rstride, c["kColsMaxChunkItems"])
    items = max(items - items % groups, groups)
    return items, items * c["kColsChunks"]


def _layout(name, tile):
    """Segment lengths and dropped ids (below 0, at or above n) around tiles
    of ``tile`` items (a segment of L rows is L + 1 items)."""
    rng = np.random.default_rng(21)
    if name == "hub":  # one segment over more than three tiles
        lengths = list(rng.integers(0, 5, 12))
        lengths[4] = 3 * tile + tile // 2
        return lengths, 3, 5
    if name == "tile_edges":  # ends on a tile's last and first items
        return [tile - 1, tile - 1, tile, 0, 0, tile + 1, 1, 2 * tile - 2, 0, 2 * tile - 1,
                2 * tile, 3 * tile - 1, 3, tile - 1], 0, 0
    if name == "all_empty":
        return [0] * (3 * tile + 5), 7, 9
    if name == "one_segment":
        return [5 * tile + 3], 0, 0
    if name == "out_of_range":  # rows outside [offsets[0], offsets[n])
        return list(rng.integers(0, 4, 30)), 2 * tile + 1, tile + 3
    raise ValueError(name)


def _tiled_case(name, tile, op, dtype, masked):
    """One layout's values (NaN on dropped float rows, which must never be
    read), ids, n, mask and offsets, as numpy arrays and offsets tensor."""
    lengths, below, above = _layout(name, tile)
    n = len(lengths)
    ids = np.concatenate([np.full(below, -1), np.repeat(np.arange(n), lengths),
                          np.full(above, n)]).astype(np.int32)
    rng = np.random.default_rng(22)
    vals = _values(rng, "float32" if dtype == "bfloat16" else dtype, ids.shape, op)
    if dtype in ("float32", "bfloat16"):
        vals[(ids < 0) | (ids >= n)] = np.nan
    mask = rng.random(ids.shape[0]) < 0.8 if masked else None
    return vals, ids, n, mask, segment_offsets(torch.from_numpy(ids), n)


def _jax_segment_reduce(vals, ids, n, op, dtype, mask):
    """``repro.graph.ops.segment_reduce`` on the same values; bf16 values
    reduce in f32 and round back to bf16, the port's stated accumulation."""
    jvals, _ = _both(vals, dtype)
    if dtype == "bfloat16":
        jvals = jvals.astype(jnp.float32)
    want = jops.segment_reduce(jvals, jnp.asarray(ids), n, op, indices_are_sorted=True,
                               mask=None if mask is None else jnp.asarray(mask))
    return want.astype(JNP[dtype])


def _assert_seg_equal(got, want, dtype, op):
    """Float sums and products at TOL, the rest exactly."""
    assert _np(got).dtype == _np(want).dtype and _np(got).shape == _np(want).shape
    if dtype in TOL and op in ("sum", "prod"):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


SEG_KERNEL_CASES = [(op, dt) for dt in ("float32", "bfloat16", "int32", "bool")
                    for op in (("min", "max", "or", "and") if dt == "bool"
                               else ("sum", "prod", "min", "max"))]


@pytest.mark.parametrize("layout", ["hub", "tile_edges", "all_empty", "one_segment",
                                    "out_of_range"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("op,dtype", SEG_KERNEL_CASES)
def test_segment_tiles_match_plain(op, dtype, masked, layout):
    """The rows route's tiling (each tile's rows and segment ends, its head
    partial and carry, the carries folded in tile order) at tiles of 16
    items == ``repro.graph.ops.segment_reduce`` on the same inputs; float
    sums and products at TOL, the rest exactly."""
    vals, ids, n, mask, off = _tiled_case(layout, 16, op, dtype, masked)
    tvals = torch.from_numpy(vals).to(TORCH[dtype])
    got, tiles = segment_reduce_tiled(tvals, off, op,
                                      None if mask is None else torch.from_numpy(mask), 16)
    _assert_seg_equal(got, _jax_segment_reduce(vals, ids, n, op, dtype, mask), dtype, op)
    assert len(tiles) <= seg_ops.n_tiles(vals.shape[0], n, 16)
    carried = [t[4] for t in tiles]
    if layout in ("hub", "one_segment"):  # a run of more than three carries
        hub = max(set(carried) - {None}, key=carried.count)
        assert carried.count(hub) >= 3 and sum(t[5] for t in tiles) >= 1
    if layout == "all_empty":
        assert all(t[2] == t[3] for t in tiles) and carried == [None] * len(tiles)


@pytest.mark.parametrize("layout", ["hub", "tile_edges", "out_of_range"])
def test_segment_tiles_at_kernel_size(layout):
    """The same at the kernel's own tiles (``kTile`` of
    csrc/segment_reduce.cu): a float sum and an int32 min over a hub of
    more than three tiles and ends on tile edges."""
    tile = _kernel_tile_items()
    for op, dtype in (("sum", "float32"), ("min", "int32")):
        vals, ids, n, mask, off = _tiled_case(layout, tile, op, dtype, True)
        got, tiles = segment_reduce_tiled(torch.from_numpy(vals), off, op,
                                          torch.from_numpy(mask), tile)
        _assert_seg_equal(got, _jax_segment_reduce(vals, ids, n, op, dtype, mask), dtype, op)
        assert len(tiles) <= seg_ops.n_tiles(vals.shape[0], n, tile)


ELEM = {"float32": 4, "bfloat16": 2, "int32": 4, "bool": 1}


def _wide_case(layout, width, op, dtype, masked):
    """:func:`_tiled_case` with rows of ``width`` elements at the cols
    route's tile for that width and dtype. Float sums are of k/16 with
    |k| <= 16, exact in f32 in any order, so that a partial dropped or
    folded twice shows at these long segments, where random values would
    differ by rounding alone."""
    tile = _cols_tiling(width, ELEM[dtype])[1]
    lengths, below, above = _layout(layout, tile)
    n = len(lengths)
    ids = np.concatenate([np.full(below, -1), np.repeat(np.arange(n), lengths),
                          np.full(above, n)]).astype(np.int32)
    rng = np.random.default_rng(24 + width)
    vals = _values(rng, "float32" if dtype == "bfloat16" else dtype, (ids.shape[0], width), op)
    if op == "sum" and dtype in ("float32", "bfloat16"):  # k/16: exact in any order
        vals = rng.integers(-16, 17, vals.shape).astype(np.float32) / 16
    if dtype in ("float32", "bfloat16"):
        vals[(ids < 0) | (ids >= n)] = np.nan
    mask = rng.random(ids.shape[0]) < 0.8 if masked else None
    return tile, vals, ids, n, mask, segment_offsets(torch.from_numpy(ids), n)


@pytest.mark.parametrize("layout", ["hub", "tile_edges", "all_empty", "out_of_range"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("width", [8, 64, 75, 100, 512])
@pytest.mark.parametrize("op,dtype", SEG_KERNEL_CASES)
def test_wide_segment_tiles_match_jax(op, dtype, width, masked, layout):
    """The cols route's tiling at its own tile for each GNN width (W-wide
    heads and carries; a hub over more than three tiles, ends on tile
    edges, all segments empty, rows outside ``[offsets[0], offsets[n])``
    planted with NaN) == ``repro.graph.ops.segment_reduce`` on the same
    inputs; float sums and products at TOL, the rest exactly."""
    tile, vals, ids, n, mask, off = _wide_case(layout, width, op, dtype, masked)
    tvals = torch.from_numpy(vals).to(TORCH[dtype])
    got, tiles = segment_reduce_tiled(tvals, off, op,
                                      None if mask is None else torch.from_numpy(mask), tile)
    _assert_seg_equal(got, _jax_segment_reduce(vals, ids, n, op, dtype, mask), dtype, op)
    assert len(tiles) <= seg_ops.n_tiles(vals.shape[0], n, tile)
    carried = [t[4] for t in tiles]
    if layout == "hub":  # a run of carries and the head that ends it
        hub = max(set(carried) - {None}, key=carried.count)
        assert carried.count(hub) >= 3 and sum(t[5] for t in tiles) >= 1


def test_cols_tiling_rule():
    """The cols route's chunks at the GNN shapes (the notes of
    csrc/segment_reduce.cu): SAGE's 400-byte rows 80 items a chunk, GAT's
    32-byte ones 1,024, PNA's 150-byte bf16 ones 216, GraphCast's 1,024-byte
    bf16 ones 32; eight chunks a tile; a chunk never stages more than
    ``kColsChunkBytes`` of rows beyond one a group; and the W-wide scratch
    at SAGE's [61,886,476, 100] f32 over 4,194,304 segments stays near
    0.1 GB (the rows route's: ``4 * n_tiles + 1`` words)."""
    c = _kernel_constants()
    for width, elem, chunk in ((100, 4, 80), (8, 4, 1024), (75, 2, 216), (512, 2, 32),
                               (128, 4, 64), (64, 4, 128)):
        assert _cols_tiling(width, elem) == (chunk, chunk * c["kColsChunks"])
    for width in range(2, 2100, 7):
        for elem in (1, 2, 4):
            chunk, tile = _cols_tiling(width, elem)
            row = width * elem if width <= c["kColsSlice"] else c["kColsSlice"] * elem + 16
            # within the chunk's bytes, or one item for each of the 8 row groups
            assert chunk * row <= c["kColsChunkBytes"] or chunk == c["kThreads"] // 32
    e, n = 61_886_476, 4_194_304
    tiles = seg_ops.n_tiles(e, n, _cols_tiling(100, 4)[1])
    assert 4 * seg_ops.scratch_words(tiles, c["kColsChunks"], 100) < 0.12e9
    rows_tiles = seg_ops.n_tiles(e, n, _kernel_tile_items())
    assert seg_ops.scratch_words(rows_tiles, 1, 1) == 4 * rows_tiles + 1


@pytest.mark.parametrize("layout", ["hub", "tile_edges", "all_empty", "out_of_range"])
@pytest.mark.parametrize("tile", [1, 3, 16])
def test_merge_tiles_brute_force(layout, tile):
    """``merge_tiles`` (the kernel's binary-search split) == merging the
    rows and the segment ends one item at a time: each tile's first and end
    segment and its row span, the rows covering ``[offsets[0], offsets[n])``
    exactly once."""
    lengths, below, _ = _layout(layout, 16)  # ids past n follow offsets[n]
    n = len(lengths)
    off = np.concatenate([[below], below + np.cumsum(lengths)]).astype(np.int32)
    items = []  # ("row", r) or ("end", s) in merge order
    s, r = 0, int(off[0])
    while s < n:
        if r < off[s + 1]:
            items.append(("row", r))
            r += 1
        else:
            items.append(("end", s))
            s += 1
    tiles = merge_tiles(torch.from_numpy(off), tile)
    assert len(tiles) == -(-len(items) // tile)
    row = int(off[0])
    for k, (s0, s1, rb, re_) in enumerate(tiles):
        chunk = items[k * tile:(k + 1) * tile]
        ends = [x for kind, x in chunk if kind == "end"]
        rows = [x for kind, x in chunk if kind == "row"]
        assert s1 - s0 == len(ends) and (not ends or ends[0] == s0)
        assert (rb, re_) == (row, row + len(rows)) and rows == list(range(rb, re_))
        row = re_
    assert row == off[n] and sum(s1 - s0 for s0, s1, _, _ in tiles) == n


# -- the kernels' build ----------------------------------------------------------


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    """On a copy of ``csrc/``: a library's name hashes its source and every
    ``csrc`` header it includes (``flash_attention.cu`` and
    ``flash_attention_bwd.cu`` share ``hopper.cuh``), so an edited header
    names a new library for both and a stale one is never loaded; a header
    that no source includes, or another kernel's source, changes nothing."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    names = ("flash_attention", "flash_attention_bwd", "gather_rows")
    before = {n: build.library_path(n) for n in names}
    assert [p.name for p in build.sources("flash_attention_bwd")] == [
        "flash_attention_bwd.cu", "hopper.cuh"]
    assert [p.name for p in build.sources("gather_rows")] == ["gather_rows.cu"]
    (csrc / "unused.cuh").write_text("#pragma once\n")
    with open(csrc / "segment_reduce.cu", "a") as f:
        f.write("// another kernel's edit\n")
    assert {n: build.library_path(n) for n in names} == before
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// an edit of the shared header\n")
    after = {n: build.library_path(n) for n in names}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["flash_attention_bwd"] != before["flash_attention_bwd"]
    assert after["gather_rows"] == before["gather_rows"]
    # a header included through another header counts too
    (csrc / "inner.cuh").write_text("#pragma once\n")
    with open(csrc / "hopper.cuh", "a") as f:
        f.write('#include "inner.cuh"\n')
    mid = build.library_path("flash_attention_bwd")
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert build.library_path("flash_attention_bwd") != mid
