"""The port's attention with query and key positions and a key mask — the
JAX package's whole ``attention_chunked`` — held to the JAX package on the
CPU, with the checks that go with it.

Inputs are drawn from numpy seeds and handed to both packages. On the CPU
the flash kernels' wrappers take their plain versions (the positions
route's, for these calls); JAX runs its own ``attention_chunked``, whose
custom VJP ``_flash`` gives ``jax.grad`` its ``_flash_bwd``. Tolerances are
``tests/test_kernels.py``'s: float32 rtol = atol = 2e-5, bfloat16 3e-2.

Rows that keep no key follow JAX's finite mask value (−1e30): the mean of
V over the ``Sk`` keys and the zero keys that pad JAX's last KV chunk
(``chunk_kv`` that pads and one that does not), and in the backward a
probability of 1 for every key.
"""

from __future__ import annotations

import signal
import types

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.graph import ops as jgops  # noqa: E402
from repro.models.transformer import attention as jattn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.graph import ops as tgops  # noqa: E402
from repro_torch.kernels import fake  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.transformer import attention as tattn  # noqa: E402
from repro_torch.models.transformer import model as ttm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dtype, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               err_msg=what, **TOL[dtype])


def _positions(kind, rng, b, sq, sk):
    """``(q_pos, k_pos, kv_mask)`` as numpy: 1-D or ``[B, S]`` int32
    positions and a bool ``[B, Sk]`` mask (``None``: no mask)."""
    if kind == "shifted":  # queries 3 ahead of the keys: the prefill of a continuation
        return np.arange(sq, dtype=np.int32) + 3, np.arange(sk, dtype=np.int32), None
    if kind == "strided":
        return 2 * np.arange(sq, dtype=np.int32), 2 * np.arange(sk, dtype=np.int32), None
    if kind == "left_padded":  # row r's prompt right-aligned after pads[r] pad slots
        pads = np.array([0, 5, sq - 1, 3][:b])[:, None]
        pos = (np.arange(sq)[None] - pads).astype(np.int32)
        return pos, pos.copy(), pos >= 0
    if kind == "random":  # [B, S] positions, 25 % of keys masked, one row all masked
        qp = rng.integers(-3, sk + 3, (b, sq)).astype(np.int32)
        kp = rng.integers(-3, sk + 3, (b, sk)).astype(np.int32)
        mask = rng.random((b, sk)) > 0.25
        mask[-1] = False
        return qp, kp, mask
    if kind == "probe":  # query 0 keeps no key under causal; key 2 masked
        return (np.array([0, 5, 6], np.int32), np.arange(1, 6, dtype=np.int32),
                np.array([[True, True, False, True, True]] * b))
    raise ValueError(kind)


#: (positions, b, sq, sk, h, hkv, d, causal, window, chunk_kv, dtype)
CASES = [
    ("shifted", 2, 8, 8, 2, 2, 8, True, None, 8, "float32"),
    ("strided", 1, 8, 8, 4, 2, 8, True, 3, 3, "float32"),
    ("strided", 2, 8, 8, 2, 1, 16, False, 5, 8, "float32"),
    ("left_padded", 4, 12, 12, 4, 2, 8, True, None, 5, "float32"),
    ("left_padded", 3, 12, 12, 4, 1, 16, True, 4, 12, "float32"),
    ("left_padded", 4, 12, 12, 4, 2, 16, True, None, 5, "bfloat16"),
    ("random", 2, 9, 11, 4, 2, 8, True, 4, 4, "float32"),
    ("random", 2, 9, 11, 4, 4, 8, False, None, 16, "float32"),
    ("random", 3, 7, 13, 2, 1, 8, False, 6, 5, "float32"),
    ("random", 2, 9, 11, 4, 2, 16, True, None, 4, "bfloat16"),
    ("probe", 1, 3, 5, 2, 1, 8, True, None, 4, "float32"),
    ("probe", 2, 3, 5, 2, 2, 8, True, None, 16, "float32"),
]


@pytest.mark.parametrize("kind,b,sq,sk,h,hkv,d,causal,window,chunk_kv,dtype", CASES)
def test_attention_chunked_matches_jax(kind, b, sq, sk, h, hkv, d, causal, window,
                                       chunk_kv, dtype):
    """The port's ``attention_chunked`` with positions and a key mask ==
    JAX's, forward and the gradients of q, k and v (``jax.grad`` through
    ``_flash`` against torch autograd through ``_FlashAttention``)."""
    rng = np.random.default_rng(sum(map(ord, kind)) + 7 * sq + d + chunk_kv)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d))]
    qp, kp, mask = _positions(kind, rng, b, sq, sk)
    jq, jk, jv = (jnp.asarray(x, JNP[dtype]) for x in arrays[:3])
    cot = arrays[3]

    def jfn(q, k, v):
        return jattn.attention_chunked(q, k, v, jnp.asarray(qp), jnp.asarray(kp), causal,
                                       window, 1024, chunk_kv,
                                       None if mask is None else jnp.asarray(mask))

    want_out = jfn(jq, jk, jv)
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v).astype(jnp.float32) * cot),
                    argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(x, dtype=TORCH[dtype], requires_grad=True)
                  for x in arrays[:3])
    out = tattn.attention_chunked(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp),
                                  causal, window, 1024, chunk_kv,
                                  None if mask is None else torch.from_numpy(mask))
    assert out.dtype == TORCH[dtype]
    _close(out, want_out, dtype, "output")
    got = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(), (tq, tk, tv))
    for name, g, w in zip("qkv", got, want):
        _close(g, w, dtype, f"d{name}")


def _cfg(window):
    return types.SimpleNamespace(swa_window=window, attn_impl="chunked",
                                 attn_chunk_q=1024, attn_chunk_kv=1024)


@pytest.mark.parametrize("q_pos,k_pos,window", [
    (np.arange(8) + 3, np.arange(8), None),
    (2 * np.arange(8), 2 * np.arange(8), 3),
])
def test_attention_reads_the_positions_it_is_given(q_pos, k_pos, window):
    """``attention`` with 1-D positions other than 0..S−1 computes with
    those positions, as JAX's does (it once read any 1-D positions of
    equal shape as 0..S−1, up to 2.76 and 2.24 from JAX's on these
    inputs)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 8, 2, 8)).astype(np.float32) for _ in range(3))
    want = jattn.attention(*map(jnp.asarray, (q, k, v, q_pos.astype(np.int32),
                                              k_pos.astype(np.int32))), _cfg(window))
    got = tattn.attention(*map(torch.from_numpy, (q, k, v, q_pos.astype(np.int32),
                                                  k_pos.astype(np.int32))), _cfg(window))
    _close(got, want, "float32", "attention")


@pytest.mark.parametrize("sq,positions,masked", [
    (1, "ring", True),  # a decode step: the dense attention
    (6, "rows", True),  # a sequence with a key mask: the flash positions route
    (6, None, False),   # no positions: 0..S−1, the flash index route
])
def test_attention_dispatch_matches_jax(sq, positions, masked):
    """``attention`` passes every argument through JAX's dispatch: dense for
    one query, flash for a sequence, ``None`` positions meaning 0..S−1."""
    rng = np.random.default_rng(sq)
    b, sk = 2, 6
    q = rng.normal(size=(b, sq, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, 2, 8)).astype(np.float32) for _ in range(2))
    qp = (np.arange(sq)[None] + np.array([[sk - sq], [2]])).astype(np.int32)
    kp = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    mask = rng.random((b, sk)) > 0.3 if masked else None
    jpos = (qp, kp) if positions else (np.arange(sq, dtype=np.int32),) * 2
    want = jattn.attention(*map(jnp.asarray, (q, k, v, *jpos)), _cfg(4),
                           kv_mask=None if mask is None else jnp.asarray(mask))
    tpos = (torch.from_numpy(qp), torch.from_numpy(kp)) if positions else (None, None)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          *tpos, _cfg(4),
                          kv_mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want, "float32", "attention")


def test_model_forward_keeps_the_index_route(monkeypatch):
    """The model's forward passes no positions to the flash attention: its
    kernel stays on the index route (no positions tensors, no host read)."""
    calls = []
    real = tattn.flash_attention

    def spy(*args, **kwargs):
        calls.append({k: kwargs.get(k) for k in ("q_pos", "k_pos", "kv_mask")})
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    cfg = tconfigs.get_spec("h2o-danube-1.8b").reduced
    params = ttm.init(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    ttm.forward(params, tokens, cfg)
    assert len(calls) == cfg.n_layers
    assert all(v is None for c in calls for v in c.values())


def test_fake_route_counts_every_visited_pair():
    """The positions route's fake launch counts every (query, key) pair,
    which the kernels visit (the kept ones are data the fake route never
    reads), × 4·D flops forward and × 10·D backward, and bumps
    ``launches_pos``; the index route keeps its kept-pair count."""
    b, h, hkv, sq, sk, d = 2, 4, 2, 24, 40, 16
    before = dryrun.launch_counts()
    fake.reset()
    with tcommon.fake_mode():
        q = torch.empty((b, h, sq, d), dtype=torch.bfloat16)
        k = torch.empty((b, hkv, sk, d), dtype=torch.bfloat16)
        qp = torch.empty((b, sq), dtype=torch.int32)
        kp = torch.empty((b, sk), dtype=torch.int32)
        mask = torch.empty((b, sk), dtype=torch.bool)
        out, lse = flash_ops.flash_attention(q, k, k, True, 8, 0.25, return_lse=True,
                                             q_pos=qp, k_pos=kp, kv_mask=mask, pad=3)
        flash_ops.flash_attention_bwd(q, k, k, out, lse, out, True, 8, 0.25,
                                      q_pos=qp, k_pos=kp, kv_mask=mask)
        flash_ops.flash_attention(q, k, k, True, 8, 0.25)
    pairs = b * h * sq * sk
    assert fake.WORK["flash_attention"]["launches"] == 2
    assert fake.WORK["flash_attention"]["flops"] == (
        pairs + b * h * fake.kept_pairs(sq, sk, True, 8)) * 4 * d
    assert fake.WORK["flash_attention_bwd"]["flops"] == pairs * 10 * d
    after = dryrun.launch_counts()
    assert after["flash_attention.launches_pos"] - before["flash_attention.launches_pos"] == 1
    assert after["flash_attention.launches"] - before["flash_attention.launches"] == 2
    assert (after["flash_attention_bwd.launches_pos"]
            - before["flash_attention_bwd.launches_pos"]) == 1


def test_positions_route_takes_positions_and_mask_together():
    """The kernels' wrappers refuse part of the positions route."""
    with tcommon.fake_mode():
        q = torch.empty((1, 2, 8, 16), dtype=torch.bfloat16)
        qp = torch.empty((1, 8), dtype=torch.int32)
        with pytest.raises(TypeError, match="together"):
            flash_ops.flash_attention(q, q, q, q_pos=qp, k_pos=qp)
        with pytest.raises(TypeError, match="int32"):
            flash_ops.flash_attention(q, q, q, q_pos=qp.long(), k_pos=qp,
                                      kv_mask=torch.empty((1, 8), dtype=torch.bool))


@pytest.mark.parametrize("sq,sk", [(200, 300), (64, 129)])
def test_bwd_schedule_positions_route(sq, sk):
    """On the positions route the tensor-core backward's blocks meet every
    query tile, and each query tile's dQ adds come from key tiles 0, 1, …
    in turn (a block waits for ``kt`` adds before its own)."""
    sched = flash_ops.bwd_schedule(2, 4, 2, sq, sk, True, 16, positions=True)
    n_qt, n_kt = -(-sq // flash_ops.BWD_BLOCK_Q), -(-sk // flash_ops.BWD_BLOCK_K)
    seen = {}
    for _, kt, steps in sched:
        assert sorted({qt for _, qt, _ in steps}) == list(range(n_qt))
        for bh, qt, before in steps:
            assert before == kt
            seen.setdefault((bh, qt), []).append(kt)
    assert len(seen) == 2 * 4 * n_qt
    assert all(v == list(range(n_kt)) for v in seen.values())


def test_supervised_run_restores_the_sigterm_handler(tmp_path):
    """After ``Supervised.run`` the SIGTERM handler is the one from before
    the run: the supervisor's, which holds the supervisor and through it
    the training state, does not outlive it."""
    spec, _, params, loss_fn, batches = ttrain.build("h2o-danube-1.8b", True, 2, 8, 0,
                                                     "cpu")
    run = ttrain.Supervised(spec.family, params, loss_fn, batches,
                            tadamw.AdamWConfig(lr=3e-4), warmup=1, total=2,
                            ckpt_dir=str(tmp_path), ckpt_every=10, device="cpu",
                            log=lambda line: None)

    def mine(signum, frame):
        pass

    old = signal.signal(signal.SIGTERM, mine)
    try:
        step, _ = run.run(1)
        assert step == 1
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, old)


def test_segment_prod_has_no_gradient_in_either_package():
    """``segment_reduce`` "prod" has no gradient in the JAX package
    (``jax.ops.segment_prod``'s scatter_mul transposes only with unique
    indices), and none in the port; "or" and "and" give bool outputs in
    both, which carry no gradient."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(10, 3)).astype(np.float32)
    ids = np.sort(rng.integers(0, 4, 10)).astype(np.int32)
    with pytest.raises(NotImplementedError, match="scatter_mul"):
        jax.grad(lambda x: jnp.sum(jgops.segment_reduce(x, jnp.asarray(ids), 4, "prod",
                                                        indices_are_sorted=True)))(
            jnp.asarray(vals))
    tv = torch.tensor(vals, requires_grad=True)
    with pytest.raises(NotImplementedError):
        tgops.segment_reduce(tv, torch.from_numpy(ids), 4, "prod",
                             indices_are_sorted=True).sum().backward()
    for op in ("or", "and"):
        want = jgops.segment_reduce(jnp.asarray(vals > 0), jnp.asarray(ids), 4, op)
        got = tgops.segment_reduce(torch.from_numpy(vals > 0), torch.from_numpy(ids), 4, op)
        assert want.dtype == jnp.bool_ and got.dtype == torch.bool
        assert not got.requires_grad
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
