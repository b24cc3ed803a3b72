"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its plain
version.

``flash_attention(q, k, v, causal=True, window=None, scale=1.0)`` takes the
layout of the JAX wrapper ``repro.kernels.flash_attention.ops.flash_attention``:
q ``[B, H, Sq, D]``, k/v ``[B, Hkv, Sk, D]``, float32 or bfloat16, D ≤ 128,
H a multiple of Hkv (query head ``h`` reads kv head ``h // (H / Hkv)``).
Positions are the row indices: key ``j`` is kept for query ``i`` iff
``j <= i`` under ``causal`` and ``i - j < window`` under a window. Scores
are ``scale · q·k`` in float32 (``scale=1`` is the TPU kernel, which has
none); a row with no key kept gives 0; the output is in q's dtype. With
``round_scores=True`` each q·k is first rounded once (to nearest even) to
the inputs' dtype and the scale multiplies the rounded score, as the JAX
package's ``attention_chunked`` does in its bf16 einsum (``einsum(bf16)
.astype(f32) * scale``); the max, the mask, the exponent and the
logsumexp all see the rounded score, and float32 inputs are unchanged.
The TPU kernel keeps its scores in f32 (``preferred_element_type``), so
the default is ``False``; the port's model path sets it.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version is taken only for tensors on the CPU or the meta device, and the
dry-run's fake tensors take the fake route (``kernels.fake``: kept pairs
× 4·D flops, × 10·D for the backward). The
kernel has two routes, chosen by :func:`route` from dtype and D alone:
bf16 with D % 8 == 0 runs on the tensor cores (TMA + ``wgmma``, counted in
``flash_attention.launches_tc``), everything else on the f32 units
(``flash_attention.launches_simt``); ``flash_attention.launches`` counts
both. No route stands in for the other when a launch fails.

``return_lse=True`` also returns each row's float32 logsumexp ``[B, H,
Sq]`` of the scaled scores over its kept keys (+inf for a row with no key
kept), which both routes then store beside the output, whose bits do not
change. :func:`flash_attention_bwd` is the backward, the CUDA kernels of
``csrc/flash_attention_bwd.cu`` or their plain version on the CPU: the
JAX package's ``_flash_bwd`` recomputing P from that logsumexp (with the
scores rounded as the forward rounded them). It has the forward's two
routes by dtype and D alone (:func:`bwd_route`): bf16 with D % 8 == 0 on
the tensor cores (TMA + ``wgmma``, one pass, counted in
``flash_attention_bwd.launches_tc``), everything else on the f32 units
(``flash_attention_bwd.launches_simt``); ``flash_attention_bwd.launches``
counts both. :func:`bwd_schedule` models the tensor-core route's walk:
the query tiles each block visits and the fixed order of its dQ adds.

The positions route (``q_pos`` int32 ``[B, Sq]``, ``k_pos`` int32 ``[B,
Sk]``, ``kv_mask`` bool ``[B, Sk]``, all three or none; and ``pad``) is the
JAX package's whole ``attention_chunked``: key ``j`` is kept for query
``i`` iff ``kv_mask[j]`` and ``q_pos[i] >= k_pos[j]`` under ``causal`` and
``q_pos[i] - k_pos[j] < window`` under a window (:func:`keep_mask`,
positions within ±2^30). Rows that keep a key are computed as on the
index route. A row that keeps no key follows JAX's finite mask value
``NEG_INF = -1e30``: its output is ``Σ_{j<Sk} v_j / (Sk + pad)``, where
``pad`` counts the zero keys that pad JAX's last chunk (``(-Sk) mod
min(chunk_kv, Sk)``), its lse is ``NEG_INF``, and the backward gives every
masked pair of a row ``P = exp(NEG_INF - lse)``: 1 in such a row, 0 in any
other. The positions are data and no host reads them: a first launch of
each kernel writes the position bounds of every 64-key tile and 64-row
query block (:func:`tile_bounds`), and both kernels, on both routes by
dtype and D, visit only the tiles that those bounds leave live
(:func:`tile_kind`; :func:`live_tiles`, :func:`tile_needs_mask`,
:func:`bwd_schedule` and :func:`walk_lists` state the walks), running
interior tiles mask-free on the tensor cores; :func:`visited` reads back
what a launch visited (the tensor cores' walk lists, the SIMT kernels'
tile counts). A row that keeps no key takes its answer in closed form:
the forward's mean of V from a column sum (:func:`column_sums_plain`), the
backward's terms from sums over such rows and over the keys
(:func:`nokey_sums_plain`, :func:`nokey_grads_plain`). Both count their
launches in ``launches_pos`` too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, fake

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the SIMT kernel's query tile and the grid's limit on tiles
_BLOCK_Q, _MAX_Q_TILES = 64, 65535
#: the tensor-core kernel's query and key tiles
TC_BLOCK_Q, TC_BLOCK_K = 128, 128
#: the tensor-core backward's query tile (a step) and key tile (a block)
BWD_BLOCK_Q, BWD_BLOCK_K = 64, 128
#: the JAX package's finite mask value (``attention.NEG_INF``)
NEG_INF = -1e30
#: the positions route's bound tiles: 64 keys, 64 query rows
#: (``csrc/positions.cuh`` ``BND``); a larger tile is the union of these
BOUND_TILE = 64
#: ``tile_kind``'s answers (``csrc/positions.cuh``)
TILE_DEAD, TILE_EDGE, TILE_INTERIOR = 0, 1, 2
#: a walk entry's tile index bits, then two 2-bit kinds (``WALK_SHIFT``)
WALK_SHIFT = 24
#: the SIMT route's visit counts at the end of the int32 scratch
VISITED_INTS = 2


def route(dtype, d: int) -> str:
    """The kernel's route for ``dtype`` and head dim ``d``: ``"tc"`` (TMA +
    ``wgmma``) for bf16 with ``d % 8 == 0``, else ``"simt"``. ``wgmma`` on
    f32 would be TF32, and TMA needs rows of a multiple of 16 bytes. The C
    entry point's ``flash_attention_uses_tc`` states the same rule."""
    return "tc" if dtype == torch.bfloat16 and d % 8 == 0 else "simt"


def bwd_route(dtype, d: int) -> str:
    """The backward's route for ``dtype`` and head dim ``d``, the forward's
    rule (:func:`route`): ``"tc"`` (TMA + ``wgmma``) for bf16 with
    ``d % 8 == 0`` (D rounded up to 16 inside, the columns past D read as
    zero), else ``"simt"`` (the C entry's ``flash_attention_bwd_uses_tc``)."""
    return "tc" if dtype == torch.bfloat16 and d % 8 == 0 else "simt"


def _bound_tiles(s: int) -> int:
    """Bound tiles of a batch row: ``ceil(S / 128) · 2`` (positions.cuh)."""
    return -(-s // (2 * BOUND_TILE)) * 2


def tile_bounds(q_pos, k_pos, kv_mask):
    """The bounds that ``tile_bounds`` (``csrc/positions.cuh``) writes, as
    int64 host tensors: ``kb [B, nk, 3]``, each 64-key tile's min and max
    *kept* key position (lo > hi where it keeps none) and whether every
    key of it is kept and below Sk; ``qb [B, nq, 2]``, each 64-row query
    block's min and max position over rows below Sq (lo > hi: no row)."""
    q_pos, k_pos, kv_mask = (t.cpu() for t in (q_pos, k_pos, kv_mask))
    b, sq = q_pos.shape
    sk = k_pos.shape[1]
    big, small = 2**31 - 1, -(2**31)
    nk, nq = _bound_tiles(sk), _bound_tiles(sq)
    kpad = torch.full((b, nk * BOUND_TILE), small, dtype=torch.int64)
    kept = torch.zeros((b, nk * BOUND_TILE), dtype=torch.bool)
    kpad[:, :sk] = k_pos.long()
    kept[:, :sk] = kv_mask
    kept = kept.view(b, nk, BOUND_TILE)
    kpad = kpad.view(b, nk, BOUND_TILE)
    kb = torch.stack([torch.where(kept, kpad, big).amin(-1),
                      torch.where(kept, kpad, small).amax(-1),
                      kept.all(-1).long()], -1)
    qpad = torch.full((b, nq * BOUND_TILE), big, dtype=torch.int64)
    qpad[:, :sq] = q_pos.long()
    qlo = qpad.view(b, nq, BOUND_TILE).amin(-1)
    qpad[:, sq:] = small
    qb = torch.stack([qlo, qpad.view(b, nq, BOUND_TILE).amax(-1)], -1)
    return kb, qb


def _union(kb, b: int, t0: int, t1: int):
    """Key tiles ``[t0, t1)`` of batch row ``b`` (``kb`` as lists) as one
    tile's bounds."""
    e = kb[b][t0:t1]
    return min(x[0] for x in e), max(x[1] for x in e), min(x[2] for x in e)


def tile_kind(q, k, causal: bool, window) -> int:
    """``TILE_DEAD``, ``TILE_EDGE`` or ``TILE_INTERIOR``: the key tile of
    bounds ``k = (lo, hi, full)`` for the query block ``q = (lo, hi)``, the
    rule of ``csrc/positions.cuh``. Dead: it keeps no key, or under causal
    its lowest key is above the block's highest query, or under a window
    the block's lowest query is ``window`` or more past its highest key —
    no pair of it is kept. Interior: every key of it is kept and below Sk,
    and every query of the block keeps each of them."""
    (qlo, qhi), (klo, khi, full) = q[:2], k
    if klo > khi or qlo > qhi:
        return TILE_DEAD
    if causal and klo > qhi:
        return TILE_DEAD
    if window is not None and qlo - khi >= window:
        return TILE_DEAD
    inner = (full and (not causal or khi <= qlo)
             and (window is None or qhi - klo < window))
    return TILE_INTERIOR if inner else TILE_EDGE


def _kinds(bounds, b: int, qt: int, kt: int, bq: int, bk: int, causal, window):
    """The kind of key tile ``kt`` (``bk`` keys) for each 64-row block of
    query tile ``qt`` (``bq`` rows) of batch row ``b``; ``bounds`` are
    :func:`tile_bounds`' as lists."""
    kb, qb = bounds
    nb = bk // BOUND_TILE
    k = _union(kb, b, kt * nb, (kt + 1) * nb)
    blocks = range(qt * bq // BOUND_TILE, (qt + 1) * bq // BOUND_TILE)
    return [tile_kind(qb[b][i], k, causal, window) for i in blocks]


def _live_table(positions, sq: int, sk: int, bq: int, bk: int, causal, window):
    """``live[b][qt][kt]``: whether the positions route visits key tile
    ``kt`` (``bk`` keys) for query tile ``qt`` (``bq`` rows) of batch row
    ``b``: live for any 64-row block of it."""
    bounds = tuple(t.tolist() for t in tile_bounds(*positions))
    return [[[any(kind != TILE_DEAD for kind in _kinds(bounds, b, qt, kt, bq, bk, causal,
                                                       window))
              for kt in range(-(-sk // bk))] for qt in range(-(-sq // bq))]
            for b in range(positions[0].shape[0])]


def live_tiles(sq: int, sk: int, causal: bool, window, bq: int = TC_BLOCK_Q,
               bk: int = TC_BLOCK_K, positions=None):
    """``[(q_tile, kt_begin, kt_end)]``: the key tiles each query tile
    visits on the index route, by the TPU kernel's skip rule as a loop
    range, the formula of both CUDA kernels. With ``positions = (q_pos,
    k_pos, kv_mask)`` the positions route's walk, ``[(b, q_tile, [kt,
    ...])]``: the key tiles of ``bk`` keys that :func:`tile_kind` leaves
    live for any 64-row block of the ``bq``-row query tile, ascending."""
    if positions is not None:
        table = _live_table(positions, sq, sk, bq, bk, causal, window)
        return [(b, qt, [kt for kt, on in enumerate(row) if on])
                for b, rows in enumerate(table) for qt, row in enumerate(rows)]
    n_kt = -(-sk // bk)
    out = []
    for qt in range(-(-sq // bq)):
        q0 = qt * bq
        end = min(n_kt, (q0 + bq - 1) // bk + 1) if causal else n_kt
        begin = 0
        if window is not None and q0 - window + 1 > 0:
            begin = (q0 - window + 1) // bk
        out.append((qt, begin, end))
    return out


def tile_needs_mask(q_lo: int, rows: int, k0: int, sk: int, causal: bool, window,
                    bk: int = TC_BLOCK_K, positions=None, b: int = 0) -> bool:
    """Whether the tensor-core kernel masks key tile ``[k0, k0 + bk)`` for
    query rows ``[q_lo, q_lo + rows)`` (one warpgroup's): the tile straddles
    Sk, the causal diagonal or the window's edge. Interior tiles skip it.
    With ``positions = (q_pos, k_pos, kv_mask)``: unless the bounds of
    batch row ``b`` prove the tile interior for those 64 rows
    (:func:`tile_kind`)."""
    if positions is not None:
        bounds = tuple(t.tolist() for t in tile_bounds(*positions))
        return _kinds(bounds, b, q_lo // rows, k0 // bk, rows, bk, causal,
                      window)[0] != TILE_INTERIOR
    return (k0 + bk > sk or (causal and k0 + bk - 1 > q_lo)
            or (window is not None and q_lo + rows - 1 - k0 >= window))


def bwd_key_tiles(qt: int, sk: int, causal: bool, window, bq: int = BWD_BLOCK_Q,
                  bk: int = BWD_BLOCK_K):
    """``(begin, end)``: the key tiles that query tile ``qt`` meets in the
    tensor-core backward, the forward's rule at its tiles (``key_tiles`` in
    ``csrc/flash_attention_bwd.cu``)."""
    q0 = qt * bq
    n_kt = -(-sk // bk)
    end = min(n_kt, (q0 + bq - 1) // bk + 1) if causal else n_kt
    begin = (q0 - window + 1) // bk if window is not None and q0 - window + 1 > 0 else 0
    return begin, end


def bwd_query_tiles(kt: int, sq: int, causal: bool, window, bq: int = BWD_BLOCK_Q,
                    bk: int = BWD_BLOCK_K):
    """``(begin, end)``: the query tiles that key tile ``kt`` meets, the same
    rule seen from the key side (``query_tiles`` in the ``.cu``)."""
    k0 = kt * bk
    n_qt = -(-sq // bq)
    begin = min(n_qt, k0 // bq) if causal else 0
    end = n_qt
    if window is not None:
        last = k0 + bk - 1 + window - 1  # the last query any key of the tile keeps
        end = 0 if last < 0 else min(n_qt, last // bq + 1)
    return begin, max(begin, end)


def bwd_schedule(batch: int, n_heads: int, n_kv_heads: int, sq: int, sk: int,
                 causal: bool, window, positions=None):
    """The tensor-core backward's walk, as its blocks run it: a list in
    launch order (``blockIdx.y`` = key tile slowest, ``blockIdx.x`` = batch
    · kv head) of ``(block, kt, steps)``, each step ``(bh, qt, before)``:
    the query tile ``qt`` of head ``bh = b·H + h`` that the block visits
    next (the group's heads in turn, each over its live query tiles in
    order) and the number of key tiles whose dQ adds into that tile must
    come first — the value the block waits for on the tile's counter
    (``before == 0``: it stores instead of adding). With ``positions =
    (q_pos, k_pos, kv_mask)`` the positions route's: the live tiles are
    those :func:`tile_kind` leaves live (64 query rows against 128 keys),
    and ``before`` counts the live key tiles below ``kt``."""
    n_rep = n_heads // n_kv_heads
    table = (None if positions is None else
             _live_table(positions, sq, sk, BWD_BLOCK_Q, BWD_BLOCK_K, causal, window))
    out = []
    for kt in range(-(-sk // BWD_BLOCK_K)):
        for bkv in range(batch * n_kv_heads):
            b, g = divmod(bkv, n_kv_heads)
            if table is None:
                tiles = range(*bwd_query_tiles(kt, sq, causal, window))
            else:
                tiles = [qt for qt, row in enumerate(table[b]) if row[kt]]
            steps = []
            for hr in range(n_rep):
                bh = b * n_heads + g * n_rep + hr
                for qt in tiles:
                    before = (kt - bwd_key_tiles(qt, sk, causal, window)[0]
                              if table is None else sum(table[b][qt][:kt]))
                    steps.append((bh, qt, before))
            out.append((kt * batch * n_kv_heads + bkv, kt, steps))
    return out


def walk_lists(positions, sq: int, sk: int, causal: bool, window, bwd: bool = False):
    """The tensor-core route's walk lists as ``fwd_walk`` / ``bwd_walk``
    (``csrc/positions.cuh``) write them, from ``positions = (q_pos, k_pos,
    kv_mask)``, in their order. Forward: ``(b, qt, kt, kind_0, kind_1)``
    for each live 128-key tile ``kt`` of each 128-row query tile ``qt``,
    ``kind_h`` the tile's kind for the query tile's 64-row half ``h``.
    Backward: ``(b, kt, qt, kind_0, kind_1, rank)`` for each live 64-row
    query tile ``qt`` of each 128-key tile ``kt``, ``kind_h`` that of the
    key tile's 64-key half ``h``, ``rank`` the live key tiles below ``kt``
    for ``qt``."""
    bounds = tuple(t.tolist() for t in tile_bounds(*positions))
    n_b = positions[0].shape[0]
    n_kt = -(-sk // BWD_BLOCK_K)
    out = []
    if not bwd:
        for b in range(n_b):
            for qt in range(-(-sq // TC_BLOCK_Q)):
                for kt in range(n_kt):
                    kinds = _kinds(bounds, b, qt, kt, TC_BLOCK_Q, TC_BLOCK_K, causal, window)
                    if any(kind != TILE_DEAD for kind in kinds):
                        out.append((b, qt, kt, *kinds))
        return out
    table = _live_table(positions, sq, sk, BWD_BLOCK_Q, BWD_BLOCK_K, causal, window)
    for b in range(n_b):
        for kt in range(n_kt):
            for qt, row in enumerate(table[b]):
                if row[kt]:
                    halves = [_kinds(bounds, b, qt, 2 * kt + i, BOUND_TILE, BOUND_TILE, causal,
                                     window)[0] for i in range(2)]
                    out.append((b, kt, qt, *halves, sum(row[:kt])))
    return out


def read_walk(ints, at: int, batch: int, sq: int, sk: int, bwd: bool = False):
    """The walk lists that the tensor-core route's kernels followed, read
    from their int32 scratch (``ints``, the walk ``at`` elements in), in
    :func:`walk_lists`' form."""
    mask = (1 << WALK_SHIFT) - 1

    def entry(e):
        return e & mask, (e >> WALK_SHIFT) & 3, (e >> (WALK_SHIFT + 2)) & 3

    if bwd:
        n_kt, n_qt, width = -(-sk // BWD_BLOCK_K), -(-sq // BWD_BLOCK_Q), 2
    else:
        n_kt, n_qt, width = -(-sq // TC_BLOCK_Q), -(-sk // TC_BLOCK_K), 1
    size = batch * n_kt * (1 + width * n_qt)
    lists = ints[at:at + size].cpu().view(batch, n_kt, 1 + width * n_qt).tolist()
    out = []
    for b in range(batch):
        for t in range(n_kt):
            row = lists[b][t]
            for i in range(row[0]):
                tile, k0, k1 = entry(row[1 + width * i])
                out.append((b, t, tile, k0, k1, *row[2 + width * i:1 + width * (i + 1)]))
    return out


def visited(fn):
    """What the latest positions-route launch of ``fn`` (:func:`flash_attention`
    or :func:`flash_attention_bwd`) on the card visited, read back from its
    int32 scratch: on the tensor-core route ``{"walk": ...}``, the lists its
    kernels followed (:func:`read_walk`); on the SIMT route ``{"tiles":
    [n, ...]}``, the 64 × 64 tiles its blocks counted as they visited them
    (the forward's, then the backward's dK/dV and dQ kernels'). None before
    any such launch."""
    w = fn.last_walk
    if w is None:
        return None
    if w["tc"]:
        return {"walk": read_walk(w["ints"], w["at"], w["batch"], w["sq"], w["sk"],
                                  bwd=fn is flash_attention_bwd)}
    tiles = w["ints"][-VISITED_INTS:].tolist()
    return {"tiles": tiles if fn is flash_attention_bwd else tiles[:1]}


def keep_mask(q_pos, k_pos, causal: bool, window, kv_mask=None) -> torch.Tensor:
    """bool ``[..., Sq, Sk]`` from position vectors ``[..., Sq]`` and
    ``[..., Sk]`` and an optional key mask ``[..., Sk]``: key ``k`` is kept
    for query ``q`` iff ``kv_mask[k]``, ``k <= q`` under ``causal`` and
    ``q - k < window`` under a window (the JAX package's ``_mask_bias``
    with its ``kv_mask``). The one statement of the rule, shared by the
    plain versions and the dense attention."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    keep = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        keep &= diff >= 0
    if window is not None:
        keep &= diff < window
    if kv_mask is not None:
        keep &= kv_mask[..., None, :]
    return keep


def _keeps(q, k, causal, window, q_pos, k_pos, kv_mask):
    """The keep mask of each batch row: ``[Sq, Sk]`` by index positions,
    shared by every row, or ``[B, Sq, Sk]`` on the positions route."""
    if q_pos is None:
        return keep_mask(torch.arange(q.shape[2], device=q.device),
                         torch.arange(k.shape[2], device=q.device), causal, window)
    return keep_mask(q_pos, k_pos, causal, window, kv_mask)


def _scores(q, k, scale, round_scores):
    """``scale · q·kᵀ`` in float32; with ``round_scores`` the product is
    taken in the inputs' dtype (f32 accumulation, each score rounded once:
    the JAX package's bf16 einsum), a no-op for float32. On the card that
    product runs on the tensor cores, as the kernels' scores do."""
    if round_scores:
        return (q @ k.transpose(-1, -2)).float() * scale
    return (q.float() @ k.float().T) * scale


def flash_attention_plain(q, k, v, causal=True, window=None, scale=1.0,
                          return_lse=False, round_scores=False, q_pos=None, k_pos=None,
                          kv_mask=None, pad=0):
    """The plain PyTorch version, one (batch, kv-head group) at a time so
    that no ``[B, H, Sq, Sk]`` score tensor is ever held: f32 scores (with
    ``round_scores`` each q·k rounded to q's dtype before the scale),
    ``-inf`` where masked, softmax, NaN rows (no key kept) to 0, p rounded
    to q's dtype, f32 product with v. On the positions route a row that
    keeps no key takes ``Σ_{j<Sk} v_j / (Sk + pad)`` and the lse
    ``NEG_INF``, as the JAX package's finite mask value gives them."""
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    keeps = _keeps(q, k, causal, window, q_pos, k_pos, kv_mask)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for bi in range(b):
        keep = keeps if q_pos is None else keeps[bi]
        for g in range(hkv):
            heads = slice(g * rep, (g + 1) * rep)
            s = _scores(q[bi, heads], k[bi, g], scale, round_scores)
            s = s.masked_fill(~keep, -torch.inf)
            row = torch.logsumexp(s, dim=-1)
            lse[bi, heads] = torch.where(torch.isinf(row), torch.inf, row)
            p = torch.softmax(s, dim=-1)
            p = torch.where(torch.isnan(p), 0.0, p).to(q.dtype).float()
            out[bi, heads] = (p @ v[bi, g].float()).to(q.dtype)
            if q_pos is not None:
                empty = ~keep.any(dim=-1)
                mean = (v[bi, g].float().sum(dim=0) / (sk + pad)).to(q.dtype)
                out[bi, heads] = torch.where(empty[:, None], mean, out[bi, heads])
                lse[bi, heads] = torch.where(empty, NEG_INF, lse[bi, heads])
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True, window=None,
                              scale=1.0, round_scores=False, q_pos=None, k_pos=None,
                              kv_mask=None):
    """The plain PyTorch backward, one (batch, kv-head group) at a time, the
    JAX package's ``_flash_bwd`` in float32: ``delta = rowsum(dO·O)``,
    ``P = exp(scale·q·k − lse)`` where kept (q·k rounded as the forward
    rounds it under ``round_scores``), ``dV = Pᵀ·dO``, ``dP = dO·Vᵀ``,
    ``dS = P·(dP − delta)·scale``, ``dQ = dS·K``, ``dK = dSᵀ·Q``, the
    group's heads summed onto their kv head; results in the inputs' dtype.
    A masked pair's P is 0 on the index route and ``exp(NEG_INF − lse)`` on
    the positions route: 1 in a row that keeps no key (lse ``NEG_INF``)."""
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    keeps = _keeps(q, k, causal, window, q_pos, k_pos, kv_mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for bi in range(b):
        keep = keeps if q_pos is None else keeps[bi]
        for g in range(hkv):
            heads = slice(g * rep, (g + 1) * rep)
            qf, kf, vf = q[bi, heads].float(), k[bi, g].float(), v[bi, g].float()
            do = dout[bi, heads].float()
            delta = (do * out[bi, heads].float()).sum(dim=-1)
            s = _scores(q[bi, heads], k[bi, g], scale, round_scores)
            row = lse[bi, heads][..., None]
            masked = 0.0 if q_pos is None else torch.exp(NEG_INF - row)
            p = torch.where(keep, torch.exp(s - row), masked)
            ds = p * (do @ vf.T - delta[..., None]) * scale
            dv[bi, g] = (p.transpose(-1, -2) @ do).sum(dim=0).to(v.dtype)
            dq[bi, heads] = (ds @ kf).to(q.dtype)
            dk[bi, g] = (ds.transpose(-1, -2) @ qf).sum(dim=0).to(k.dtype)
    return dq, dk, dv


def column_sums_plain(v):
    """f32 ``[B, Hkv, D]``: the sum of V over its Sk keys, which the
    positions route's forward divides by ``Sk + pad`` for a row that keeps
    no key (``column_sums`` in ``csrc/flash_attention.cu``)."""
    return v.float().sum(dim=2)


def nokey_sums_plain(q, k, v, out, lse, dout):
    """The backward's sums for the rows that keep no key (lse ``NEG_INF``),
    per (batch, kv head), in float32 (``gram_kernel`` and ``sum_chunks`` in
    ``csrc/flash_attention_bwd.cu``), over the no-key rows ``i`` of the
    group's heads and the keys ``j < Sk``: ``sigma = Σ dO_i``, ``N = Σ q_i
    dO_iᵀ`` ``[D, D]``, ``rho = Σ delta_i q_i``, ``A = Σ k_j v_jᵀ``,
    ``kappa = Σ k_j``, and ``count``, the no-key rows."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    w = (lse == NEG_INF).float().reshape(b, hkv, -1)

    def rows(t):
        return t.float().reshape(b, hkv, -1, d)

    qf, do = rows(q), rows(dout)
    delta = (do * rows(out)).sum(-1)
    kf, vf = k.float(), v.float()
    return {"sigma": (w[..., None] * do).sum(2),
            "N": torch.einsum("bgr,bgrc,bgre->bgce", w, qf, do),
            "rho": ((w * delta)[..., None] * qf).sum(2),
            "A": torch.einsum("bgjc,bgje->bgce", kf, vf), "kappa": kf.sum(2),
            "count": w.sum(-1).long()}


def nokey_grads_plain(q, k, v, out, lse, dout, scale, sums=None):
    """The closed-form backward of the rows that keep no key, float32
    ``(dq, dk, dv)`` to add to the tile walk's (in which those rows take
    P = 0): JAX gives such a row P = 1 on every key ``j < Sk`` (its pad
    keys are zero and add nothing), so ``dV_j += sigma``, ``dK_j += scale ·
    (N v_j − rho)`` and ``dQ_i = scale · (A dO_i − delta_i kappa)`` on the
    no-key rows, with :func:`nokey_sums_plain`'s sums."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    t = nokey_sums_plain(q, k, v, out, lse, dout) if sums is None else sums
    none = (lse == NEG_INF)[..., None]
    g = lambda x: x.repeat_interleave(h // hkv, dim=1)  # noqa: E731
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    dq = torch.where(none, scale * (torch.einsum("bhce,bhie->bhic", g(t["A"]), do)
                                    - delta * g(t["kappa"])[:, :, None]), 0.0)
    dk = scale * (torch.einsum("bgce,bgje->bgjc", t["N"], v.float())
                  - t["rho"][:, :, None])
    dv = t["sigma"][:, :, None].expand(b, hkv, k.shape[2], d)
    return dq, dk, dv


@functools.cache
def _entry():
    """The C entry point of the kernel's library, typed."""
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, *[ctypes.c_void_p] * 5, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _scratch(lib: str, entry: str, *args):
    """Element counts ``(ints, floats)`` and the walk's offset in the ints,
    from a library's scratch entry."""
    fn = getattr(build.library(lib), entry)
    out = [ctypes.c_longlong() for _ in range(3)]
    fn.restype = None
    fn(*args, *map(ctypes.byref, out))
    return tuple(x.value for x in out)


def pos_scratch(q, k, bwd: bool = False):
    """The positions route's int32 and f32 scratch on q's device, sized by
    the C entry (``flash_attention_pos_scratch`` or
    ``flash_attention_bwd_pos_scratch``): the tile bounds, the walk, and
    the column sums of V (forward) or the no-key sums and counts
    (backward); and where in the int32 scratch the walk begins."""
    b, _, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    c = ctypes.c_longlong
    if bwd:
        n_int, n_float, at = _scratch("flash_attention_bwd",
                                      "flash_attention_bwd_pos_scratch", c(b),
                                      ctypes.c_int(hkv), c(sq), c(sk), ctypes.c_int(d))
    else:
        n_int, n_float, at = _scratch("flash_attention", "flash_attention_pos_scratch",
                                      c(b), ctypes.c_int(hkv), c(sq), c(sk),
                                      ctypes.c_int(d), ctypes.c_int(_DTYPE_CODE[q.dtype]))
    return (torch.empty(n_int, dtype=torch.int32, device=q.device),
            torch.empty(n_float, dtype=torch.float32, device=q.device), at)


def _keep_walk(fn, ints, at: int, q, k, tc: bool):
    """Keeps the int32 scratch of ``fn``'s latest positions launch, which
    :func:`visited` reads back."""
    fn.last_walk = {"ints": ints, "at": at, "batch": q.shape[0], "heads": q.shape[1],
                    "sq": q.shape[2], "sk": k.shape[2], "tc": tc}


@functools.cache
def _bwd_entry():
    """The C entry point of the backward kernels' library, typed."""
    fn = build.library("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [
        ctypes.c_int, *[ctypes.c_void_p] * 12, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, *[ctypes.c_void_p] * 5, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_scratch_entry():
    fn = build.library("flash_attention_bwd").flash_attention_bwd_scratch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   *[ctypes.POINTER(ctypes.c_longlong)] * 3]
    fn.restype = None
    return fn


def bwd_scratch(bh: int, sq: int, d: int):
    """Element counts of the tensor-core backward's scratch for ``bh =
    B·H`` heads of ``sq`` rows: f32 rows (lse and delta), the f32 dQ
    accumulator and the int32 counters, as the C entry's
    ``flash_attention_bwd_scratch`` gives them."""
    out = [ctypes.c_longlong() for _ in range(3)]
    _bwd_scratch_entry()(bh, sq, d, *map(ctypes.byref, out))
    return tuple(x.value for x in out)


@functools.cache
def _probe_entry():
    fn = build.library("flash_attention").flash_attention_probe
    fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 6, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tc_uses_tensor_cores(dtype, d: int) -> bool:
    """The C entry point's own route rule (``flash_attention_uses_tc``)."""
    fn = build.library("flash_attention").flash_attention_uses_tc
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return bool(fn(_DTYPE_CODE[dtype], d))


def tile_probe(q, k, v, p):
    """One tile of each tensor-core product, on the card: q bf16 ``[Sq, D]``,
    k/v ``[Sk, D]``, p bf16 ``[64, 128]``; returns f32 ``s = q[:64] ·
    k[:128]ᵀ`` ``[64, 128]`` and ``o = p · v[:128]`` ``[64, D]``, rows past
    Sq/Sk read as zero. A check of the descriptors and the swizzle."""
    sq, d = q.shape
    dp = -(-d // 16) * 16
    s = torch.empty((64, TC_BLOCK_K), dtype=torch.float32, device=q.device)
    o = torch.empty((64, dp), dtype=torch.float32, device=q.device)
    rc = _probe_entry()(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        s.data_ptr(), o.data_ptr(), sq, k.shape[0], d,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention tile probe failed: CUDA error {rc}")
    return s, o[:, :d]


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise TypeError(
            f"flash_attention needs q [B,H,Sq,D], k = v [B,Hkv,Sk,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise TypeError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if k.shape[1] < 1 or h % k.shape[1]:
        raise TypeError(f"{h} query heads are not a multiple of {k.shape[1]} kv heads")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= 128:
        raise ValueError(f"head dim {d} outside 1..128")
    if -(-sq // _BLOCK_Q) > _MAX_Q_TILES:
        raise ValueError(f"Sq = {sq} exceeds the kernel's grid")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if (route(q.dtype, d) == "tc" and not fake.is_fake(q)
            and any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("the tensor-core route needs q, k and v 16-byte aligned")


def _check_positions(q, k, q_pos, k_pos, kv_mask, pad) -> bool:
    """Whether the call takes the positions route; raises on positions, a
    key mask or a pad that the kernels do not take."""
    given = [t is not None for t in (q_pos, k_pos, kv_mask)]
    if not any(given):
        return False
    if not all(given):
        raise TypeError("the positions route takes q_pos, k_pos and kv_mask together")
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    for name, t, shape, dtype in (("q_pos", q_pos, (b, sq), torch.int32),
                                  ("k_pos", k_pos, (b, sk), torch.int32),
                                  ("kv_mask", kv_mask, (b, sk), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} {list(shape)}, got {t.dtype} "
                            f"{list(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if int(pad) < 0:
        raise ValueError(f"pad {pad} < 0")
    return True


def _pair_flops(q, k, causal, window, per_pair: int, positions: bool = False) -> int:
    """``per_pair · D`` flops for every kept (query, key) pair of every head;
    on the positions route, whose kept pairs are data that the fake route
    never reads, every pair: the upper bound of what the kernels visit (the
    live tiles, :func:`live_tiles`, are the data's too)."""
    b, h, sq, d = q.shape
    pairs = (sq * k.shape[2] if positions
             else fake.kept_pairs(sq, k.shape[2], causal, window))
    return pairs * b * h * per_pair * d


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention(q, k, v, causal=True, window=None, scale=1.0, return_lse=False,
                    round_scores=False, q_pos=None, k_pos=None, kv_mask=None, pad=0):
    """Attention on the card by ``csrc/flash_attention.cu``; see module."""
    if not fake.on_card(q):
        return flash_attention_plain(q, k, v, causal, window, scale, return_lse,
                                     round_scores, q_pos, k_pos, kv_mask, pad)
    _check(q, k, v)
    positions = _check_positions(q, k, q_pos, k_pos, kv_mask, pad)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if fake.is_fake(q):
        fake.record("flash_attention",
                    fake.nbytes(q, k, v, out, lse, q_pos, k_pos, kv_mask),
                    _pair_flops(q, k, causal, window, 4, positions))
        return _count_fwd(q, out, lse, return_lse, positions)
    ints, floats, at = pos_scratch(q, k) if positions else (None, None, 0)
    rc = _entry()(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _ptr(lse), b, h, k.shape[1], sq, k.shape[2], d,
        _DTYPE_CODE[q.dtype], int(bool(causal)), int(window is not None),
        0 if window is None else int(window), float(scale), int(bool(round_scores)),
        _ptr(q_pos), _ptr(k_pos), _ptr(kv_mask), _ptr(ints), _ptr(floats), float(pad),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    if positions:
        _keep_walk(flash_attention, ints, at, q, k, route(q.dtype, d) == "tc")
    return _count_fwd(q, out, lse, return_lse, positions)


def _count_fwd(q, out, lse, return_lse, positions):
    flash_attention.launches += 1
    if route(q.dtype, q.shape[3]) == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_simt += 1
    flash_attention.launches_pos += int(positions)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_simt = 0
flash_attention.launches_pos = 0
flash_attention.last_walk = None


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=None, scale=1.0,
                        round_scores=False, q_pos=None, k_pos=None, kv_mask=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` on the card by
    ``csrc/flash_attention_bwd.cu`` (the plain version for CPU tensors):
    ``out`` and ``lse`` from the forward with ``return_lse=True`` and the
    same ``round_scores``, ``dout`` the output's cotangent ``[B, H, Sq,
    D]``. The tensor-core route takes its scratch from ``torch.empty``:
    an f32 dQ accumulator ``[B·H, ⌈Sq/64⌉, 64, D rounded up to 16]`` (168
    MB at h2o-danube's training shape) beside f32 rows and int32 counters.
    The positions route takes the forward's ``q_pos``, ``k_pos`` and
    ``kv_mask`` (its pad is in ``out``)."""
    if not fake.on_card(q):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, window, scale,
                                         round_scores, q_pos, k_pos, kv_mask)
    _check(q, k, v)
    positions = _check_positions(q, k, q_pos, k_pos, kv_mask, 0)
    b, h, sq, d = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} must be like q, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd needs a contiguous {name}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError(f"lse must be contiguous float32 [B, H, Sq], got "
                        f"{lse.dtype} {tuple(lse.shape)}")
    if -(-k.shape[2] // _BLOCK_Q) > _MAX_Q_TILES:
        raise ValueError(f"Sk = {k.shape[2]} exceeds the kernel's grid")
    tc = bwd_route(q.dtype, d) == "tc"
    if fake.is_fake(q):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        fake.record("flash_attention_bwd",
                    fake.nbytes(q, k, v, out, lse, dout, dq, dk, dv, q_pos, k_pos, kv_mask),
                    _pair_flops(q, k, causal, window, 10, positions))
        return _count_bwd(tc, dq, dk, dv, positions)
    if tc and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("the backward's tensor-core route needs q, k, v and dout "
                         "16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    acc = counters = None
    if tc:
        n_rows, n_acc, n_counters = bwd_scratch(b * h, sq, d)
        rows = torch.empty(n_rows, dtype=torch.float32, device=q.device)
        acc = torch.empty(n_acc, dtype=torch.float32, device=q.device)
        counters = torch.empty(n_counters, dtype=torch.int32, device=q.device)
    else:
        rows = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)  # delta
    ints, floats, at = pos_scratch(q, k, bwd=True) if positions else (None, None, 0)
    rc = _bwd_entry()(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
        None if acc is None else acc.data_ptr(),
        None if counters is None else counters.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], sq, k.shape[2], d,
        _DTYPE_CODE[q.dtype], int(bool(causal)), int(window is not None),
        0 if window is None else int(window), float(scale), int(bool(round_scores)),
        _ptr(q_pos), _ptr(k_pos), _ptr(kv_mask), _ptr(ints), _ptr(floats),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    if positions:
        _keep_walk(flash_attention_bwd, ints, at, q, k, tc)
    return _count_bwd(tc, dq, dk, dv, positions)


def _count_bwd(tc: bool, dq, dk, dv, positions: bool):
    flash_attention_bwd.launches += 1
    if tc:
        flash_attention_bwd.launches_tc += 1
    else:
        flash_attention_bwd.launches_simt += 1
    flash_attention_bwd.launches_pos += int(positions)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0
flash_attention_bwd.launches_simt = 0
flash_attention_bwd.launches_pos = 0
flash_attention_bwd.last_walk = None
