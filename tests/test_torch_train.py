"""The port's training slice against the JAX package, on the CPU.

Gradients: each kernel's backward (``repro_torch.kernels.autograd``, here
on the wrappers' plain versions, as on the CPU they are) against
``jax.grad`` of the JAX function it stands for; the reduced models'
losses and gradients against ``jax.value_and_grad`` of the JAX
``loss_fn``s, the JAX package's own initialised parameters carried across;
the optimiser, the schedule and the LM data against ``repro.optim`` and
``repro.data.pipeline``; five trainer steps of three families against
JAX's ``step_fn``; and the step's determinism.

Tolerances, each with its reason:

* kernel gradients: ``TOL`` of tests/test_kernels.py (f32 rtol = atol =
  2e-5, bf16 3e-2), the absolute part scaled by the largest |gradient|
  (sums of many terms in other orders); the tie rule exactly;
* model losses to 1e-5 relative; every gradient leaf within
  1e-4 · max|g_jax| (f32: the two packages sum in other orders through
  two layers and an online softmax); h2o-danube in bf16 within 3e-2 ·
  max|g| (bf16 rounds at other places). The reduced configs all run in
  f32. PNA's bf16 gradients are not compared: at the reduced size its
  first layer's gradients sit 27-68 % of max|g| from the f32 model's in
  both packages (bf16 through the std aggregator), and the port's, whose
  bf16 segment sums accumulate in f32 where JAX's accumulate in bf16,
  differ from JAX's by up to 30 % there (its tail and head by 2 %);
* the schedule to 1e-7, AdamW's f32 parameters and moments to 1e-6 after
  five steps, its bf16 parameters and moments bit for bit (the f32 update
  rounded once, as JAX does), the token batches bit for bit;
* the trainer's per-step losses to 1e-5 relative (f32 reduced configs).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.graph import generators as jgen  # noqa: E402
from repro.graph import ops as jops  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.gnn import models as jgm  # noqa: E402
from repro.models.recsys import autoint as jai  # noqa: E402
from repro.models.transformer import attention as jattn  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.graph import ops as tops  # noqa: E402
from repro_torch.kernels import autograd as kgrad  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tflash  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.gnn import GNNConfig as TGNNConfig  # noqa: E402
from repro_torch.models.gnn import models as tgm  # noqa: E402
from repro_torch.models.recsys import autoint as tai  # noqa: E402
from repro_torch.models.transformer import attention as tattn  # noqa: E402
from repro_torch.models.transformer import model as ttm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD_F32, GRAD_BF16, LOSS_REL = 1e-4, 3e-2, 1e-5


def _t(x):
    """A numpy/JAX array as a tensor (bf16 bit for bit)."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _both(x: np.ndarray, dtype: str):
    j = jnp.asarray(x).astype(JNP[dtype])
    return j, _t(j).requires_grad_(True)


def _close(got, want, tol):
    """Within ``tol`` relative, or ``tol`` · max|want| absolute."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


# -- kernel backwards against jax.grad -------------------------------------------

N_ROWS = 50
#: duplicates, a hub (row 7, 40 times), and ids -1, N, 2^31 - 1
GATHER_IDS = np.concatenate([
    np.full(40, 7), np.arange(N_ROWS), [3, 3, 3, -1, N_ROWS, 2**31 - 1, -N_ROWS, -3],
]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [None, 3], ids=["rows", "rows3"])
@pytest.mark.parametrize("fill", [None, 0.5], ids=["clip", "fill"])
def test_gather_grad_matches_jax(fill, width, dtype):
    """``graph.ops.gather``'s field gradient (clip: ids clipped into the
    table; fill: ``[-n, -1]`` wrapped, the rest dropped) == ``jax.grad`` of
    ``repro.graph.ops.gather``; duplicates and the hub summed."""
    rng = np.random.default_rng(0)
    shape = (N_ROWS,) if width is None else (N_ROWS, width)
    jf, tf = _both(rng.normal(size=shape), dtype)
    ids = rng.permutation(GATHER_IDS)
    cot = rng.normal(size=(ids.shape[0],) + shape[1:]).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(
        jops.gather(f, jnp.asarray(ids), fill).astype(jnp.float32) * cot))(jf)
    out = tops.gather(tf, torch.from_numpy(ids), fill)
    (got,) = torch.autograd.grad((out.float() * _t(cot)).sum(), tf)
    assert got.dtype == tf.dtype
    _close(got, want, TOL[dtype])


SEG_N = 12
#: ascending ids: empty segments 0, 5, 11; a hub (segment 3, 30 rows);
#: ids -1 and N at the ends (dropped)
SEG_IDS = np.concatenate([
    [-1, -1], np.full(2, 1), np.full(4, 2), np.full(30, 3), [4], np.full(5, 6),
    np.full(3, 7), np.full(6, 8), [9], np.full(4, 10), [SEG_N, SEG_N],
]).astype(np.int32)


def _segment_values(rng, op, width):
    """Values with ties planted: every segment's extremum appears twice in
    segment 3 and three times in segment 8 (in the first column)."""
    shape = (SEG_IDS.shape[0],) if width is None else (SEG_IDS.shape[0], width)
    vals = rng.integers(-4, 5, size=shape).astype(np.float32) / 4
    if op in ("max", "min"):
        ext = 9.0 if op == "max" else -9.0
        for seg, n in ((3, 2), (8, 3)):
            rows = np.flatnonzero(SEG_IDS == seg)[:n]
            vals[rows] = ext
    return vals


@pytest.mark.parametrize("width", [None, 3], ids=["rows", "rows3"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_grad_matches_jax(op, masked, width):
    """``graph.ops.segment_reduce``'s values gradient == ``jax.grad`` of
    ``repro.graph.ops.segment_reduce`` (sum: the cotangent gathered by
    segment; max/min: split evenly across planted ties, JAX's rule),
    with empty segments, a hub, dropped ids -1 and N, and a mask."""
    rng = np.random.default_rng(1)
    vals = _segment_values(rng, op, width)
    jv, tv = _both(vals, "float32")
    mask = rng.random(SEG_IDS.shape[0]) < 0.8 if masked else None
    if masked and op in ("max", "min"):  # a masked-off tie does not split
        mask[np.flatnonzero(SEG_IDS == 8)[0]] = False
    cot = rng.normal(size=(SEG_N,) + vals.shape[1:]).astype(np.float32)

    def jfun(v):
        out = jops.segment_reduce(v, jnp.asarray(SEG_IDS), SEG_N, op,
                                  indices_are_sorted=True,
                                  mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * cot)

    want = jax.grad(jfun)(jv)
    out = tops.segment_reduce(tv, torch.from_numpy(SEG_IDS), SEG_N, op,
                              indices_are_sorted=True,
                              mask=None if mask is None else torch.from_numpy(mask))
    (got,) = torch.autograd.grad(
        (torch.where(torch.isfinite(out), out, 0.0) * _t(cot)).sum(), tv)
    _close(got, want, TOL["float32"])


def test_segment_max_tie_rule_is_jax():
    """The tie rule alone: a segment of three equal maxima gives each a
    third of the cotangent; a segment whose maximum is the identity
    (-inf) counts the initial value as one more tie (1/(n + 1))."""
    vals = np.array([2.0, 2.0, 2.0, 1.0, -np.inf, -np.inf], np.float32)
    ids = np.array([0, 0, 0, 0, 1, 1], np.int32)
    jv, tv = _both(vals, "float32")
    want = jax.grad(lambda v: jnp.sum(
        jops.segment_reduce(v, jnp.asarray(ids), 2, "max") * jnp.array([3.0, 6.0])))(jv)
    out = tops.segment_reduce(tv, torch.from_numpy(ids), 2, "max", indices_are_sorted=True)
    (got,) = torch.autograd.grad((out * torch.tensor([3.0, 6.0])).sum(), tv)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got), [1.0, 1.0, 1.0, 0.0, 2.0, 2.0])


@pytest.mark.parametrize("op", ["prod", "or", "and"])
def test_segment_grad_raises_without_rule(op):
    """prod, or and and have no gradient in the port: the backward raises."""
    if op == "prod":
        v = torch.ones(4, requires_grad=True)
        out = tops.segment_reduce(v, torch.tensor([0, 0, 1, 1], dtype=torch.int32), 2,
                                  op, indices_are_sorted=True)
        with pytest.raises(NotImplementedError, match="prod"):
            out.sum().backward()
    else:  # bool and int paths never carry a gradient
        v = torch.ones(4)
        out = tops.segment_reduce(v, torch.tensor([0, 0, 1, 1], dtype=torch.int32), 2,
                                  op, indices_are_sorted=True)
        assert not out.requires_grad


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_edge_softmax_grad_matches_jax(masked):
    """``edge_softmax``'s gradient, through its segment max (no
    stop-gradient in JAX either), with tied maxima and a mask."""
    rng = np.random.default_rng(2)
    vals = _segment_values(rng, "max", 2)
    jv, tv = _both(vals, "float32")
    mask = rng.random(SEG_IDS.shape[0]) < 0.8 if masked else None
    ids = np.clip(SEG_IDS, 0, SEG_N - 1)  # edge_softmax reads every id
    cot = rng.normal(size=vals.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jops.edge_softmax(
        v, jnp.asarray(ids), SEG_N, None if mask is None else jnp.asarray(mask),
        indices_are_sorted=True) * cot))(jv)
    out = tops.edge_softmax(tv, torch.from_numpy(ids), SEG_N,
                            None if mask is None else torch.from_numpy(mask),
                            indices_are_sorted=True)
    (got,) = torch.autograd.grad((out * _t(cot)).sum(), tv)
    _close(got, want, TOL["float32"])


def test_autoint_lookup_grad_matches_jax():
    """``autoint.lookup``'s table gradient == ``jax.grad`` of the JAX
    ``lookup`` (clipped flat ids; an out-of-range id of one field lands on
    another field's row), Zipf ids with heavy duplicates."""
    cfg = jconfigs.get_spec("autoint").reduced
    jp = jai.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)
    fields = (rng.zipf(1.2, size=(64, cfg.n_fields)) % cfg.vocab_per_field).astype(np.int32)
    fields[0, :3] = [-1, cfg.vocab_per_field, 2**31 - 1 - cfg.n_fields * cfg.vocab_per_field]
    cot = rng.normal(size=(64, cfg.n_fields, cfg.embed_dim)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jai.lookup({"tables": t}, jnp.asarray(fields)) * cot))(
        jp["tables"])
    tables = _t(jp["tables"]).requires_grad_(True)
    out = tai.lookup({"tables": tables}, torch.from_numpy(fields))
    (got,) = torch.autograd.grad((out * _t(cot)).sum(), tables)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["weights", "weights+mask"])
def test_embedding_bag_grads_match_jax(masked, dtype):
    """``embedding_bag``'s table and weights gradients == ``jax.grad`` of
    ``embedding_bag_ref`` on weighted bags of 5 with a hub id, ids -1, V
    and 2^31 - 1 (clipped)."""
    rng = np.random.default_rng(4)
    v, d, b, h = 30, 8, 16, 5
    jt, tt = _both(rng.normal(size=(v, d)), dtype)
    idx = rng.integers(0, v, (b, h)).astype(np.int32)
    idx[:, 0] = 4
    idx[0, 1:4] = [-1, v, 2**31 - 1]
    w = rng.normal(size=(b, h)).astype(np.float32)
    mask = rng.random((b, h)) < 0.7 if masked else None
    jw, tw = _both(w, dtype)
    weff = lambda w_: w_ if mask is None else w_ * jnp.asarray(mask).astype(w_.dtype)  # noqa: E731
    cot = rng.normal(size=(b, d)).astype(np.float32)
    want_t, want_w = jax.grad(
        lambda t, w_: jnp.sum(embedding_bag_ref(t, jnp.asarray(idx), weff(w_))
                              .astype(jnp.float32) * cot), argnums=(0, 1))(jt, jw)
    out = kgrad.embedding_bag(tt, torch.from_numpy(idx), tw,
                              None if mask is None else torch.from_numpy(mask))
    got_t, got_w = torch.autograd.grad((out.float() * _t(cot)).sum(), (tt, tw))
    _close(got_t, want_t, TOL[dtype])
    _close(got_w, want_w, TOL[dtype])


#: (b, s, h, hkv, d, window): GQA with n_rep 4 and a binding window at
#: D = 80, MHA at D = 128, a window past every key
ATTN_CASES = [(2, 70, 8, 2, 80, 24), (1, 40, 4, 4, 128, None), (2, 33, 4, 1, 16, 100)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,d,window", ATTN_CASES)
def test_attention_chunked_grad_matches_jax(b, s, h, hkv, d, window, dtype):
    """``attention_chunked``'s q/k/v gradients (the flash backward's plain
    version) == ``jax.grad`` through the JAX custom VJP ``_flash_bwd``."""
    rng = np.random.default_rng(5)
    jq, tq = _both(rng.normal(size=(b, s, h, d)), dtype)
    jk, tk = _both(rng.normal(size=(b, s, hkv, d)), dtype)
    jv, tv = _both(rng.normal(size=(b, s, hkv, d)), dtype)
    cot = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pos = jnp.arange(s, dtype=jnp.int32)
    want = jax.grad(lambda q, k, v: jnp.sum(jattn.attention_chunked(
        q, k, v, pos, pos, causal=True, window=window, chunk_kv=16)
        .astype(jnp.float32) * cot), argnums=(0, 1, 2))(jq, jk, jv)
    out = tattn.attention_chunked(tq, tk, tv, causal=True, window=window)
    got = torch.autograd.grad((out.float() * _t(cot)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        assert g.dtype == TORCH[dtype]
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("b,s,h,hkv,d,window", ATTN_CASES)
def test_attention_chunked_bf16_matches_jax(b, s, h, hkv, d, window):
    """``attention_chunked`` in bf16 == JAX's ``attention_chunked`` in bf16
    on the same seeded inputs, forward and ``jax.grad``, each within
    1e-2 · max|·| (about two bf16 steps: both round each score q·k to bf16
    before the scale (``round_scores``), P and the output to bf16 at the
    same places, and sum in other orders; the port's one softmax against
    JAX's online one over chunks of 16 keys)."""
    rng = np.random.default_rng(12)
    jq, tq = _both(rng.normal(size=(b, s, h, d)), "bfloat16")
    jk, tk = _both(rng.normal(size=(b, s, hkv, d)), "bfloat16")
    jv, tv = _both(rng.normal(size=(b, s, hkv, d)), "bfloat16")
    cot = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pos = jnp.arange(s, dtype=jnp.int32)

    def jfn(q, k, v):
        return jattn.attention_chunked(q, k, v, pos, pos, causal=True, window=window,
                                       chunk_kv=16)

    want_out = jfn(jq, jk, jv)
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v).astype(jnp.float32) * cot),
                    argnums=(0, 1, 2))(jq, jk, jv)
    out = tattn.attention_chunked(tq, tk, tv, causal=True, window=window)
    assert out.dtype == torch.bfloat16
    _close(out.detach(), want_out, 1e-2)
    got = torch.autograd.grad((out.float() * _t(cot)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, 1e-2)


def test_flash_lse_matches_jax():
    """The forward's logsumexp (``return_lse=True``) == JAX's
    ``_flash_fwd_impl`` lse, and the output is the same tensor as without."""
    rng = np.random.default_rng(6)
    b, s, h, hkv, d = 2, 50, 8, 2, 16
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, hkv, hkv))
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    _, want = jattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                                    pos, jnp.ones((b, s), jnp.bool_), True, 20, s)
    tq, tk, tv = (_t(x).transpose(1, 2).contiguous() for x in (q, k, v))
    out, lse = tflash.flash_attention(tq, tk, tv, True, 20, d**-0.5, return_lse=True)
    _close(lse, want, TOL["float32"])
    assert torch.equal(out, tflash.flash_attention(tq, tk, tv, True, 20, d**-0.5))


def test_flash_grad_is_zero_on_rows_without_keys():
    """A query row with no key kept (the port gives 0 there, JAX the mean
    of V) gets a zero gradient, and nothing of it reaches k or v: lse is
    +inf on such a row, so every P of it is 0."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 6, 8)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    # non-causal, window 0: i - j < 0 keeps only keys after the query; the
    # last row keeps none
    out, lse = tflash.flash_attention(q, k, v, False, 0, 0.3, return_lse=True)
    assert torch.isinf(lse[..., -1]).all() and (lse[..., -1] > 0).all()
    assert torch.isfinite(lse[..., :-1]).all()
    out = kgrad.flash_attention(q, k, v, False, 0, 0.3)
    assert torch.equal(out[..., -1, :], torch.zeros_like(out[..., -1, :]))
    cot = torch.zeros_like(out)
    cot[..., -1, :] = 1.0
    dq, dk, dv = torch.autograd.grad((out * cot).sum(), (q, k, v))
    assert torch.equal(dq, torch.zeros_like(dq))
    assert torch.equal(dk, torch.zeros_like(dk)) and torch.equal(dv, torch.zeros_like(dv))


# -- whole-model gradients against jax.value_and_grad ---------------------------


def _leaves_close(convert, jgrads, tgrads, tol):
    """Every gradient leaf of JAX's tree (carried across by ``convert``)
    within ``tol`` · max|g_jax| of the port's, leaf by leaf by name."""
    want = tadamw.named_leaves(convert(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert set(want) == set(tgrads)
    for name, w in want.items():
        w = _np(w)
        np.testing.assert_allclose(_np(tgrads[name]), w, rtol=0,
                                   atol=tol * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=name)


def _check_model(jloss, jparams, convert, tloss, jbatch, tbatch, grad_tol=GRAD_F32):
    """Loss to 1e-5 relative and every gradient leaf to ``grad_tol`` ·
    max|g| between ``jax.value_and_grad(jloss)`` and the port's."""
    want_loss, want_g = jax.value_and_grad(jloss)(jparams, jbatch)
    tparams = convert(jax.tree_util.tree_map(np.asarray, jparams), trainable=True)
    loss, grads = ttrain.value_and_grad(tloss, tparams, tbatch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_REL)
    _leaves_close(convert, want_g, grads, grad_tol)


def _lm_convert(cfg):
    return lambda tree, trainable=False: ttm.params_from_arrays(
        cfg, tree, "cpu", trainable=trainable)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-moe-16b"])
def test_lm_loss_and_grads_match_jax(arch):
    """The reduced LM's ``loss_fn`` (cross-entropy + 0.01·aux, remat on)
    and its gradients == JAX's; 48 tokens bind h2o-danube's 32-wide
    window, and the MoE's 96 tokens overflow some experts' capacity."""
    spec = jconfigs.get_spec(arch)
    jcfg, tcfg = spec.reduced, tconfigs.get_spec(arch).reduced
    jp = jtm.init(jax.random.PRNGKey(1), jcfg)
    batch = next(jpipe.token_batches(2, 48, jcfg.vocab_size, seed=2))
    tb = {k: _t(v) for k, v in batch.items()}
    _check_model(lambda p, b: jtm.loss_fn(p, b, jcfg), jp, _lm_convert(tcfg),
                 lambda p, b: ttm.loss_fn(p, b, tcfg), batch, tb)


def test_lm_bf16_grads_match_jax():
    """The reduced h2o-danube in bf16: loss and gradients within the bf16
    tolerance (3e-2 · max|g|)."""
    jcfg = dataclasses.replace(jconfigs.get_spec("h2o-danube-1.8b").reduced,
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_spec("h2o-danube-1.8b").reduced,
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jtm.init(jax.random.PRNGKey(1), jcfg)
    batch = next(jpipe.token_batches(2, 48, jcfg.vocab_size, seed=2))
    want_loss, want_g = jax.value_and_grad(lambda p, b: jtm.loss_fn(p, b, jcfg))(jp, batch)
    tp = ttm.params_from_arrays(tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu",
                                trainable=True)
    loss, grads = ttrain.value_and_grad(lambda p, b: ttm.loss_fn(p, b, tcfg), tp,
                                        {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=GRAD_BF16)
    _leaves_close(_lm_convert(tcfg), want_g, grads, GRAD_BF16)


def _gnn_convert(cfg):
    return lambda tree, trainable=False: tgm.params_from_arrays(
        cfg, tree, "cpu", trainable=trainable)


def _port_gnn_cfg(cfg):
    return TGNNConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("arch", ["graphsage-reddit", "gat-cora", "pna", "graphcast"])
def test_gnn_loss_and_grads_match_jax(arch):
    """``gm.loss_fn`` of each reduced GNN on the trainer's full batch (node
    classification with a label mask; GraphCast's masked regression)."""
    jcfg = jconfigs.get_spec(arch).reduced
    tcfg = _port_gnn_cfg(jcfg)
    jp = jgm.init(jax.random.PRNGKey(3), jcfg)
    jb = jpipe.gnn_full_batch(64, 6.0, jcfg.d_in, jcfg.n_out, seed=4, task=jcfg.task,
                              n_out=jcfg.n_out)
    tb = {k: _t(v) for k, v in jb.items()}
    _check_model(lambda p, b: jgm.loss_fn(p, b, jcfg), jp, _gnn_convert(tcfg),
                 lambda p, b: tgm.loss_fn(p, b, tcfg), jb, tb)


def _union_batch(task, n_out, d_in, seed=5):
    """Three small graphs in the disjoint-union layout (ascending
    ``graph_id``) with graph-level labels."""
    rng = np.random.default_rng(seed)
    sizes = (5, 7, 4)
    gid = np.repeat(np.arange(3), sizes).astype(np.int32)
    starts = np.cumsum((0,) + sizes[:-1])
    src, dst = [], []
    for s0, n in zip(starts, sizes):
        e = rng.integers(0, n, (2, 3 * n)) + s0
        src.append(e[0])
        dst.append(e[1])
    src, dst = np.concatenate(src), np.concatenate(dst)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
    labels = (rng.normal(size=(3, n_out)).astype(np.float32) if task == "regression"
              else rng.integers(0, n_out, 3).astype(np.int32))
    return {"x": rng.normal(size=(gid.shape[0], d_in)).astype(np.float32), "src": src,
            "dst": dst, "emask": np.ones(src.shape[0], bool), "graph_id": gid,
            "labels": labels}


@pytest.mark.parametrize("task,variant", [
    ("regression", "sage"), ("graph_class", "gat"), ("node_class", "sage")],
    ids=["regression-graph_id", "graph_class", "node_class-nomask"])
def test_gnn_loss_branches_match_jax(task, variant):
    """``loss_fn``'s other task branches: per-graph regression and graph
    classification over ``graph_id`` pools, node classification without a
    label mask."""
    base = jconfigs.get_spec("gat-cora" if variant == "gat" else "graphsage-reddit").reduced
    jcfg = dataclasses.replace(base, task=task)
    tcfg = _port_gnn_cfg(jcfg)
    jp = jgm.init(jax.random.PRNGKey(6), jcfg)
    arrays = _union_batch(task, jcfg.n_out, jcfg.d_in)
    if task == "node_class":
        arrays.pop("graph_id")
        arrays["labels"] = np.random.default_rng(1).integers(
            0, jcfg.n_out, arrays["x"].shape[0]).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: _t(v) for k, v in arrays.items()}
    _check_model(lambda p, b: jgm.loss_fn(p, b, jcfg), jp, _gnn_convert(tcfg),
                 lambda p, b: tgm.loss_fn(p, b, tcfg), jb, tb)


def test_sage_minibatch_loss_and_grads_match_jax():
    """``sage_minibatch_loss`` on one sampled batch of JAX's pipeline,
    fed to both packages."""
    jcfg = jconfigs.get_spec("graphsage-reddit").reduced
    tcfg = _port_gnn_cfg(jcfg)
    jp = jgm.init(jax.random.PRNGKey(7), jcfg)
    g = jgen.erdos_renyi(120, 6.0, seed=2)
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(120, jcfg.d_in)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, jcfg.n_out, 120).astype(np.int32))
    jb = next(jpipe.gnn_minibatches(g, feats, labels, 16, jcfg.fanouts, seed=3))
    tb = {k: _t(v) for k, v in jb.items()}
    _check_model(lambda p, b: jgm.sage_minibatch_loss(p, b, jcfg), jp, _gnn_convert(tcfg),
                 lambda p, b: tgm.sage_minibatch_loss(p, b, tcfg), jb, tb)


def test_autoint_loss_and_grads_match_jax():
    """AutoInt's ``loss_fn`` (sigmoid BCE) and its gradients, the tables'
    dense gradient through ``embedding_bag``'s backward included."""
    jcfg = jconfigs.get_spec("autoint").reduced
    tcfg = tconfigs.get_spec("autoint").reduced
    jp = jai.init(jax.random.PRNGKey(8), jcfg)
    jb = next(jpipe.recsys_batches(64, jcfg.n_fields, jcfg.vocab_per_field, seed=9))
    tb = {k: _t(v) for k, v in jb.items()}
    convert = lambda tree, trainable=False: tai.params_from_arrays(  # noqa: E731
        tcfg, tree, "cpu", trainable=trainable)
    _check_model(lambda p, b: jai.loss_fn(p, b, jcfg), jp, convert,
                 lambda p, b: tai.loss_fn(p, b, tcfg), jb, tb)


# -- optimiser, schedule, data ----------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 20, 60, 100, 150])
def test_cosine_schedule_matches_jax(step):
    """Warmup, its end, mid-decay, the end and past it, to 1e-7."""
    want = float(jschedule.cosine_schedule(step, warmup=20, total=100))
    got = tschedule.cosine_schedule(torch.tensor(step, dtype=torch.int32), warmup=20,
                                    total=100)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-7


def _mixed_tree(rng):
    return {
        "a": rng.normal(size=(6, 5)).astype(np.float32),
        "b": {"w": jnp.asarray(rng.normal(size=(4, 3))).astype(jnp.bfloat16),
              "z": rng.normal(size=(7,)).astype(np.float32)},
        "c": [jnp.asarray(rng.normal(size=(3,))).astype(jnp.bfloat16)],
    }


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"], ids=["f32", "bf16-state"])
@pytest.mark.parametrize("clip", [0.05, 1e6], ids=["clipped", "unclipped"])
def test_adamw_matches_jax(clip, state_dtype):
    """Five AdamW steps on a mixed f32/bf16 tree, clipping active or not,
    moments in f32 or bf16, fed the same gradients and schedule: f32
    leaves within 1e-6, bf16 leaves bit for bit."""
    rng = np.random.default_rng(10)
    cfg_kw = dict(lr=1e-2, clip_norm=clip, state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _mixed_tree(rng))
    tp = {"a": _t(jp["a"]), "b": {"w": _t(jp["b"]["w"]), "z": _t(jp["b"]["z"])},
          "c": [_t(jp["c"][0])]}
    jo, to = jadamw.adamw_init(jp, jcfg), tadamw.adamw_init(tp, tcfg)
    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape) * 3).astype(x.dtype), jp)
        tg = tadamw.named_leaves(jax.tree_util.tree_map(_t, g))
        scale = jschedule.cosine_schedule(jo["step"], warmup=2, total=5)
        jp, jo = jadamw.adamw_update(g, jo, jp, jcfg, lr_scale=scale)
        tadamw.adamw_update_(tp, tg, to, tcfg,
                             lr_scale=tschedule.cosine_schedule(to["step"], 2, 5))
    assert int(to["step"]) == int(jo["step"]) == 5 and to["step"].dtype == torch.int32
    for tree_j, tree_t in ((jp, tp), (jo["m"], to["m"]), (jo["v"], to["v"])):
        want = tadamw.named_leaves(jax.tree_util.tree_map(_t, tree_j))
        got = tadamw.named_leaves(tree_t)
        for name, w in want.items():
            assert got[name].dtype == w.dtype, name
            if w.dtype == torch.bfloat16:
                assert torch.equal(got[name], w), name
            else:
                np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                           atol=1e-6, err_msg=name)


def test_token_batches_equal_jax():
    """The first three LM batches bit for bit, int32 in both."""
    jit = jpipe.token_batches(3, 17, 1000, seed=4)
    tit = tpipe.token_batches(3, 17, 1000, seed=4, device="cpu")
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# -- the trainer end to end ------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, WARMUP = 5, 2, 40, 2


def _jax_losses(arch, params):
    """JAX's ``step_fn`` (``repro.launch.train``'s, without the mesh) over
    ``TRAIN_STEPS`` steps of its ``build``'s batches."""
    _, _, _, loss_fn, batch_for_step = jtrain.build(arch, True, TRAIN_BATCH, TRAIN_SEQ, 0)
    oc = jadamw.AdamWConfig(lr=3e-4)
    state = {"params": params, "opt": jadamw.adamw_init(params, oc)}

    @jax.jit
    def step_fn(state, batch):
        p, o = state["params"], state["opt"]
        loss, g = jax.value_and_grad(loss_fn)(p, batch)
        lr_scale = jschedule.cosine_schedule(o["step"], warmup=WARMUP, total=TRAIN_STEPS)
        p, o = jadamw.adamw_update(g, o, p, oc, lr_scale=lr_scale)
        return {"params": p, "opt": o}, loss

    losses = []
    for i in range(TRAIN_STEPS):
        state, loss = step_fn(state, batch_for_step(i))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gat-cora", "autoint"])
def test_trainer_losses_match_jax_step_fn(arch):
    """``repro_torch.launch.train.train`` for five reduced steps on the CPU,
    from JAX's initial parameters carried across, on the same batches:
    every step's loss within 1e-5 of JAX's ``step_fn``, and the JAX
    trainer's log lines."""
    _, _, jparams, _, _ = jtrain.build(arch, True, TRAIN_BATCH, TRAIN_SEQ, 0)
    want = _jax_losses(arch, jparams)
    lines = []
    got = ttrain.train(arch, True, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, warmup=WARMUP,
                       device="cpu", log_every=1, log=lines.append,
                       params=jax.tree_util.tree_map(np.asarray, jparams))
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    assert lines[0].startswith("step     1 loss ")
    assert lines[-1] == f"done at step {TRAIN_STEPS}: loss={got[-1]:.4f}"


def test_trainer_cli_runs(capsys, tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu`` prints
    a loss line per ``--log-every`` steps and the ``done`` line (the CLI
    checkpoints, as JAX's: into a fresh ``--ckpt-dir``)."""
    ttrain.main(["--arch", "autoint", "--reduced", "--device", "cpu", "--steps", "4",
                 "--batch", "8", "--log-every", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in out[:2]] == ["2", "4"]
    assert out[-1].startswith("done at step 4: loss=")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gat-cora", "autoint",
                                  "deepseek-moe-16b"])
def test_train_step_is_deterministic(arch):
    """Two CPU runs of one step from the same seed give bit-equal
    parameters and moments."""
    def one_step():
        _, _, p, loss_fn, bfs = ttrain.build(arch, True, 2, 24, 0, "cpu")
        oc = tadamw.AdamWConfig()
        state = {"params": p, "opt": tadamw.adamw_init(p, oc)}
        ttrain.make_step(loss_fn, oc, 2, 5)(state, bfs(0))
        return {**{f"p/{k}": v.detach().clone() for k, v in tadamw.named_leaves(p).items()},
                **{f"m/{k}": v for k, v in state["opt"]["m"].items()}}

    a, b = one_step(), one_step()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_opt_state_from_arrays_carries_jax_state():
    """JAX's AdamW state (bf16 moments) as the port's, leaf for leaf."""
    jcfg = jconfigs.get_spec("h2o-danube-1.8b").reduced
    tcfg = tconfigs.get_spec("h2o-danube-1.8b").reduced
    jp = jtm.init(jax.random.PRNGKey(0), jcfg)
    jo = jadamw.adamw_init(jp, jadamw.AdamWConfig(state_dtype="bfloat16"))
    jo = {**jo, "m": jax.tree_util.tree_map(lambda x: x + 1, jo["m"]),
          "step": jnp.asarray(3, jnp.int32)}
    to = tadamw.opt_state_from_arrays(_lm_convert(tcfg),
                                      jax.tree_util.tree_map(np.asarray, jo))
    assert int(to["step"]) == 3 and to["step"].dtype == torch.int32
    tp = ttm.params_from_arrays(tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert to["m"].keys() == tadamw.named_leaves(tp).keys()
    for k, m in to["m"].items():
        assert m.dtype == torch.bfloat16 and bool((m == 1).all()), k

