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

The kernels' walk is held here through its mirrors in the wrapper: the
tile rule against every pair (``keep_mask``), its walk on positions
0..S−1 against the index route's, the tensor-core backward's schedule of
ordered dQ adds, and the live-tile walk with the closed-form terms of
the rows that keep no key against JAX.
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


def _tile_positions(kind, b, sq, sk, seed=0):
    """``(q_pos, k_pos, kv_mask)`` torch tensors for the tile-rule tests:
    ``left_padded`` (prompts right-aligned, random pads, 10 % of the
    remaining keys masked), ``random`` (positions over the whole range, 10 %
    masked) and ``arange`` (0..S−1, no key masked); in the first two the
    last batch row keeps no key at all."""
    rng = np.random.default_rng(seed)
    if kind == "arange":
        qp = np.tile(np.arange(sq, dtype=np.int32), (b, 1))
        kp = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
        return tuple(map(torch.from_numpy, (qp, kp, np.ones((b, sk), bool))))
    if kind == "left_padded":
        pads = rng.integers(0, sk, (b, 1))
        kp = (np.arange(sk)[None] - pads).astype(np.int32)
        qp = (np.arange(sq)[None] + sk - sq - pads).astype(np.int32)
        mask = (kp >= 0) & (rng.random((b, sk)) >= 0.1)
    else:
        qp = rng.integers(0, sk + 40, (b, sq)).astype(np.int32)
        kp = rng.integers(0, sk + 40, (b, sk)).astype(np.int32)
        mask = rng.random((b, sk)) >= 0.1
    mask[-1] = False
    return tuple(map(torch.from_numpy, (qp, kp, mask)))


#: (positions, b, sq, sk, causal, window): Sq and Sk off the multiples of
#: 64 and 128, causal with and without a window, neither, a window alone
TILE_CASES = [
    ("left_padded", 3, 300, 333, True, None),
    ("left_padded", 3, 300, 333, True, 90),
    ("left_padded", 2, 200, 457, False, None),
    ("random", 3, 190, 270, True, 60),
    ("random", 2, 257, 129, False, 40),
    ("random", 2, 129, 300, False, None),
]


@pytest.mark.parametrize("kind,b,sq,sk,causal,window", TILE_CASES)
@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 128), (64, 128)])
def test_tile_rule_against_every_pair(kind, b, sq, sk, causal, window, bq, bk):
    """The positions route's tile rule (``tile_bounds``, ``tile_kind``,
    the walks of ``live_tiles`` and ``tile_needs_mask``) against
    ``keep_mask`` pair by pair, at each kernel's tiles (the SIMT routes'
    64 × 64, the tensor-core forward's 128 × 128 with its two warpgroups'
    64-row halves, the tensor-core backward's 64 × 128): a tile the walk
    skips keeps no pair, and a tile it runs mask-free keeps every pair of
    its rows below Sq (and holds no key past Sk). Every key tile of a
    batch row that keeps no key is skipped."""
    positions = _tile_positions(kind, b, sq, sk, seed=sq + sk + bq)
    keep = flash_ops.keep_mask(positions[0], positions[1], causal, window, positions[2])
    walk = flash_ops.live_tiles(sq, sk, causal, window, bq, bk, positions=positions)
    assert len(walk) == b * -(-sq // bq)
    visited = 0
    for bi, qt, kts in walk:
        rows = keep[bi, qt * bq:(qt + 1) * bq]
        assert kts == sorted(kts)
        for kt in range(-(-sk // bk)):
            tile = rows[:, kt * bk:(kt + 1) * bk]
            if kt not in kts:
                assert not bool(tile.any()), (bi, qt, kt)
                continue
            visited += tile.numel()
            for half in range(bq // 64):  # a warpgroup's (or the block's) 64 rows
                q_lo = qt * bq + 64 * half
                if q_lo >= sq:
                    continue
                if not flash_ops.tile_needs_mask(q_lo, 64, kt * bk, sk, causal, window, bk,
                                                 positions=positions, b=bi):
                    assert kt * bk + bk <= sk
                    assert bool(keep[bi, q_lo:q_lo + 64, kt * bk:(kt + 1) * bk].all())
        if bi == b - 1:
            assert kts == []  # the last row keeps no key
    assert visited >= int(keep.sum())


@pytest.mark.parametrize("sq,sk,hkv", [(64, 64, 1), (300, 333, 8)])
def test_tile_rule_is_the_index_route_on_arange(sq, sk, hkv):
    """With positions 0..S−1 and no key masked the positions route walks
    the index route's tiles and runs the same tiles mask-free, on every
    kernel's tiles, and its backward schedule is the index route's."""
    positions = _tile_positions("arange", 2, sq, sk)
    for causal, window in ((True, None), (True, 70), (False, 100), (False, None)):
        for bq, bk in ((64, 64), (128, 128), (64, 128)):
            index = flash_ops.live_tiles(sq, sk, causal, window, bq, bk)
            walk = flash_ops.live_tiles(sq, sk, causal, window, bq, bk, positions=positions)
            for (qt, begin, end), (_, qt2, kts) in zip(index, walk[:len(index)]):
                assert qt == qt2 and kts == list(range(begin, end))
        for q_lo in range(0, sq - 63, 64):
            for k0 in range(0, sk, 128):
                assert (flash_ops.tile_needs_mask(q_lo, 64, k0, sk, causal, window)
                        == flash_ops.tile_needs_mask(q_lo, 64, k0, sk, causal, window,
                                                     positions=positions))
        assert (flash_ops.bwd_schedule(2, 8, hkv, sq, sk, causal, window)
                == flash_ops.bwd_schedule(2, 8, hkv, sq, sk, causal, window,
                                          positions=positions))


@pytest.mark.parametrize("kind,sq,sk,causal,window", [
    ("left_padded", 200, 300, True, None),
    ("left_padded", 333, 257, True, 80),
    ("random", 64, 129, True, 16),
    ("random", 190, 400, False, 50),
])
def test_bwd_schedule_positions_route(kind, sq, sk, causal, window):
    """The positions route's tensor-core backward schedule: each (head,
    query tile) gets its dQ adds from exactly its live key tiles (64 rows
    against 128 keys), in ascending key order and in launch order; each
    step's ``before`` counts the live key tiles below its own, the first
    stores; and every add a step waits for comes from a block launched
    before it (no step waits on a later key tile)."""
    b, h, hkv = 3, 4, 2
    positions = _tile_positions(kind, b, sq, sk, seed=sq * sk)
    sched = flash_ops.bwd_schedule(b, h, hkv, sq, sk, causal, window, positions=positions)
    live = {(bi, qt): kts for bi, qt, kts in flash_ops.live_tiles(
        sq, sk, causal, window, flash_ops.BWD_BLOCK_Q, flash_ops.BWD_BLOCK_K,
        positions=positions)}
    seen = {}
    for block, kt, steps in sched:
        for bh, qt, before in steps:
            adds = seen.setdefault((bh, qt), [])
            assert before == len(adds)  # every live key tile below kt came first
            assert all(k_ < kt for k_ in adds)
            adds.append(kt)
    for bi in range(b):
        for hh in range(h):
            for qt in range(-(-sq // flash_ops.BWD_BLOCK_Q)):
                assert seen.get((bi * h + hh, qt), []) == live[(bi, qt)]
    assert [block for block, _, _ in sched] == list(range(len(sched)))


def _pack_walk(lists, batch, n_rows, n_cols, width, at):
    """An int32 scratch holding ``lists`` (``walk_lists``' form) as
    ``fwd_walk`` (``width`` 1) or ``bwd_walk`` (``width`` 2) lay them out
    in ``csrc/positions.cuh``, ``at`` elements in, the rest of it junk."""
    walk = torch.full((batch, n_rows, 1 + width * n_cols), -7, dtype=torch.int32)
    walk[:, :, 0] = 0
    for b, t, tile, k0, k1, *rank in lists:
        n = int(walk[b, t, 0])
        walk[b, t, 1 + width * n] = tile | k0 << flash_ops.WALK_SHIFT | k1 << (
            flash_ops.WALK_SHIFT + 2)
        if rank:
            walk[b, t, 2 + width * n] = rank[0]
        walk[b, t, 0] = n + 1
    return torch.cat([torch.full((at,), 99, dtype=torch.int32), walk.flatten(),
                      torch.full((5,), -3, dtype=torch.int32)])


@pytest.mark.parametrize("kind,b,sq,sk,causal,window", TILE_CASES)
def test_walk_lists_are_the_rule(kind, b, sq, sk, causal, window):
    """The tensor-core walk lists that the smoke holds the card's against
    (``walk_lists``) are the rule's walks: the forward's live 128-key tiles
    of each 128-row query tile, ascending, each warpgroup half mask-free iff
    ``tile_needs_mask`` says so; the backward's live 64-row query tiles of
    each 128-key tile with ``bwd_schedule``'s ranks, each 64-key half
    interior only where it keeps every pair. ``read_walk`` reads them back
    from the kernels' layout."""
    positions = _tile_positions(kind, b, sq, sk, seed=3 * sq + sk)
    keep = flash_ops.keep_mask(positions[0], positions[1], causal, window, positions[2])
    fwd = flash_ops.walk_lists(positions, sq, sk, causal, window)
    live = flash_ops.live_tiles(sq, sk, causal, window, 128, 128, positions=positions)
    assert [(bi, qt, kt) for bi, qt, kt, *_ in fwd] == [
        (bi, qt, kt) for bi, qt, kts in live for kt in kts]
    for bi, qt, kt, *kinds in fwd:
        for half, kind_ in enumerate(kinds):
            q_lo = qt * 128 + 64 * half
            if q_lo < sq:
                assert (kind_ == flash_ops.TILE_INTERIOR) == (not flash_ops.tile_needs_mask(
                    q_lo, 64, kt * 128, sk, causal, window, 128, positions=positions, b=bi))
    bwd = flash_ops.walk_lists(positions, sq, sk, causal, window, bwd=True)
    sched = flash_ops.bwd_schedule(b, 1, 1, sq, sk, causal, window, positions=positions)
    by_row = sorted(sched, key=lambda e: (e[0] % b, e[1]))  # block = kt · B + b
    assert [(bi, kt, qt, rank) for bi, kt, qt, _, _, rank in bwd] == [
        (block % b, kt, qt, before) for block, kt, steps in by_row for _, qt, before in steps]
    for bi, kt, qt, *kinds, _ in bwd:
        for half, kind_ in enumerate(kinds):
            k0 = kt * 128 + 64 * half
            tile = keep[bi, qt * 64:(qt + 1) * 64, k0:k0 + 64]
            if kind_ == flash_ops.TILE_DEAD:
                assert not bool(tile.any())
            if kind_ == flash_ops.TILE_INTERIOR:
                assert k0 + 64 <= sk and bool(tile.all())
    for lists, rows, cols, width, flag in (
            (fwd, -(-sq // 128), -(-sk // 128), 1, False),
            (bwd, -(-sk // 128), -(-sq // 64), 2, True)):
        ints = _pack_walk(lists, b, rows, cols, width, at=37)
        assert flash_ops.read_walk(ints, 37, b, sq, sk, bwd=flag) == lists


def _walk(q, k, v, dout, lse, positions, causal, window, scale, pad):
    """The positions route's tile walk as the kernels take it, in float32
    at their SIMT tiles (64 × 64): each query tile visits only its live key
    tiles (``live_tiles``) with an online softmax from ``NEG_INF`` (a
    masked score ``NEG_INF``, a key past Sk ``-inf``); a row whose max is
    still ``NEG_INF`` takes ``column_sums_plain / (Sk + pad)``. The
    backward walk gives a masked pair and every pair of a row that keeps
    no key P = 0, then adds ``nokey_grads_plain``. Returns out, dq, dk, dv."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    keep = flash_ops.keep_mask(*positions[:2], causal, window, positions[2])
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    out = torch.zeros_like(qf)
    vsum = flash_ops.column_sums_plain(v)
    walk = flash_ops.live_tiles(sq, sk, causal, window, 64, 64, positions=positions)
    for bi, qt, kts in walk:
        rows = slice(qt * 64, min(sq, (qt + 1) * 64))
        for hh in range(h):
            g = hh // rep
            m = torch.full((rows.stop - rows.start,), flash_ops.NEG_INF)
            l, acc = torch.zeros_like(m), torch.zeros((m.numel(), d))
            for kt in kts:
                cols = slice(kt * 64, min(sk, (kt + 1) * 64))
                s_ = scale * qf[bi, hh, rows] @ kf[bi, g, cols].T
                s_ = torch.where(keep[bi, rows, cols], s_, flash_ops.NEG_INF)
                m_new = torch.maximum(m, s_.max(-1).values)
                p = torch.exp(s_ - m_new[:, None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + p @ vf[bi, g, cols]
                m = m_new
            none = (m == flash_ops.NEG_INF)[:, None]
            out[bi, hh, rows] = torch.where(none, vsum[bi, g] / (sk + pad),
                                            acc / l.clamp_min(1e-30)[:, None])
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    delta = (do * out).sum(-1)
    for bi, qt, kts in walk:
        rows = slice(qt * 64, min(sq, (qt + 1) * 64))
        for hh in range(h):
            g = hh // rep
            for kt in kts:
                cols = slice(kt * 64, min(sk, (kt + 1) * 64))
                s_ = scale * qf[bi, hh, rows] @ kf[bi, g, cols].T
                p = torch.where(keep[bi, rows, cols],
                                torch.exp(s_ - lse[bi, hh, rows][:, None]), 0.0)
                ds = p * (do[bi, hh, rows] @ vf[bi, g, cols].T
                          - delta[bi, hh, rows][:, None]) * scale
                dv[bi, g, cols] += p.T @ do[bi, hh, rows]
                dq[bi, hh, rows] += ds @ kf[bi, g, cols]
                dk[bi, g, cols] += ds.T @ qf[bi, hh, rows]
    extra = flash_ops.nokey_grads_plain(q, k, v, out.to(q.dtype), lse, dout, scale)
    return out, dq + extra[0], dk + extra[1], dv + extra[2]


#: (positions, b, sq, sk, h, hkv, d, causal, window, chunk_kv, dtype); each
#: case has rows that keep no key
WALK_CASES = [
    ("left_padded", 4, 12, 12, 4, 2, 8, True, None, 5, "float32"),
    ("left_padded", 3, 70, 150, 2, 1, 16, True, 40, 64, "float32"),
    ("random", 2, 90, 140, 4, 2, 8, True, 30, 64, "float32"),
    ("random", 3, 7, 13, 2, 1, 8, False, 6, 5, "float32"),
    ("left_padded", 4, 12, 12, 4, 2, 16, True, None, 5, "bfloat16"),
]


@pytest.mark.parametrize("kind,b,sq,sk,h,hkv,d,causal,window,chunk_kv,dtype", WALK_CASES)
def test_tile_walk_and_closed_form_match_jax(kind, b, sq, sk, h, hkv, d, causal, window,
                                             chunk_kv, dtype):
    """The kernels' design in plain PyTorch: the live-tile walk (no-key rows
    at P = 0) plus the closed-form terms of the rows that keep no key (the
    forward's column sum; sigma, N, rho, A, kappa) gives JAX's
    ``attention_chunked`` forward and ``jax.grad``, and equals the plain
    versions (``flash_attention_plain``, ``flash_attention_bwd_plain``),
    which visit every pair."""
    rng = np.random.default_rng(sum(map(ord, kind)) + sq + sk + d)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d))]
    if kind == "left_padded" and sq == sk:
        qp, kp, mask = _positions(kind, rng, b, sq, sk)
    else:
        qp, kp, mask = (t.numpy() for t in _tile_positions(kind, b, sq, sk, seed=d))
    jq, jk, jv = (jnp.asarray(x, JNP[dtype]) for x in arrays[:3])
    cot = arrays[3]

    def jfn(q, k, v):
        return jattn.attention_chunked(q, k, v, jnp.asarray(qp), jnp.asarray(kp), causal,
                                       window, 1024, chunk_kv, jnp.asarray(mask))

    want_out = jfn(jq, jk, jv)
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v).astype(jnp.float32) * cot),
                    argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tdo = (torch.tensor(x, dtype=TORCH[dtype]).transpose(1, 2).contiguous()
                       for x in arrays)
    positions = tuple(map(torch.from_numpy, (qp, kp, mask)))
    pad = (-sk) % min(chunk_kv, sk)
    scale = d**-0.5
    _, lse = flash_ops.flash_attention_plain(tq, tk, tv, causal, window, scale, True,
                                             q_pos=positions[0], k_pos=positions[1],
                                             kv_mask=positions[2], pad=pad)
    none = lse == flash_ops.NEG_INF
    assert bool(none.any()) and not bool(none.all())
    out, dq, dk, dv = _walk(tq, tk, tv, tdo, lse, positions, causal, window, scale, pad)
    _close(out.transpose(1, 2), want_out, dtype, "output")
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        _close(g.transpose(1, 2), w, dtype, f"d{name}")
    plain = flash_ops.flash_attention_bwd_plain(
        tq, tk, tv, out.to(tq.dtype), lse, tdo, causal, window, scale, q_pos=positions[0],
        k_pos=positions[1], kv_mask=positions[2])
    for name, g, w in zip("qkv", (dq, dk, dv), plain):
        np.testing.assert_allclose(g.numpy(), w.float().numpy(), err_msg=f"d{name}",
                                   **TOL[dtype])


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
