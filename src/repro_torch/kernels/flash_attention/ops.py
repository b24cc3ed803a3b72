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
version is taken only for tensors on the CPU or the meta device. The
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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the SIMT kernel's query tile and the grid's limit on tiles
_BLOCK_Q, _MAX_Q_TILES = 64, 65535
#: the tensor-core kernel's query and key tiles
TC_BLOCK_Q, TC_BLOCK_K = 128, 128
#: the tensor-core backward's query tile (a step) and key tile (a block)
BWD_BLOCK_Q, BWD_BLOCK_K = 64, 128


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


def live_tiles(sq: int, sk: int, causal: bool, window, bq: int = TC_BLOCK_Q,
               bk: int = TC_BLOCK_K):
    """``[(q_tile, kt_begin, kt_end)]``: the key tiles each query tile
    visits, by the TPU kernel's skip rule as a loop range, the formula of
    both CUDA kernels."""
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
                    bk: int = TC_BLOCK_K) -> bool:
    """Whether the tensor-core kernel masks key tile ``[k0, k0 + bk)`` for
    query rows ``[q_lo, q_lo + rows)`` (one warpgroup's): the tile straddles
    Sk, the causal diagonal or the window's edge. Interior tiles skip it."""
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
                 causal: bool, window):
    """The tensor-core backward's walk, as its blocks run it: a list in
    launch order (``blockIdx.y`` = key tile slowest, ``blockIdx.x`` = batch
    · kv head) of ``(block, kt, steps)``, each step ``(bh, qt, before)``:
    the query tile ``qt`` of head ``bh = b·H + h`` that the block visits
    next (the group's heads in turn, each over its live query tiles in
    order) and the number of key tiles whose dQ adds into that tile must
    come first — the value the block waits for on the tile's counter
    (``before == 0``: it stores instead of adding)."""
    n_rep = n_heads // n_kv_heads
    out = []
    for kt in range(-(-sk // BWD_BLOCK_K)):
        qb, qe = bwd_query_tiles(kt, sq, causal, window)
        for bkv in range(batch * n_kv_heads):
            b, g = divmod(bkv, n_kv_heads)
            steps = []
            for hr in range(n_rep):
                bh = b * n_heads + g * n_rep + hr
                for qt in range(qb, qe):
                    steps.append((bh, qt, kt - bwd_key_tiles(qt, sk, causal, window)[0]))
            out.append((kt * batch * n_kv_heads + bkv, kt, steps))
    return out


def keep_mask(q_pos, k_pos, causal: bool, window) -> torch.Tensor:
    """bool ``[..., Sq, Sk]`` from position vectors ``[..., Sq]`` and
    ``[..., Sk]``: key ``k`` is kept for query ``q`` iff ``k <= q`` under
    ``causal`` and ``q - k < window`` under a window. The one statement of
    the rule, shared by the plain version and the dense attention."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    keep = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        keep &= diff >= 0
    if window is not None:
        keep &= diff < window
    return keep


def _scores(q, k, scale, round_scores):
    """``scale · q·kᵀ`` in float32; with ``round_scores`` the product is
    taken in the inputs' dtype (f32 accumulation, each score rounded once:
    the JAX package's bf16 einsum), a no-op for float32. On the card that
    product runs on the tensor cores, as the kernels' scores do."""
    if round_scores:
        return (q @ k.transpose(-1, -2)).float() * scale
    return (q.float() @ k.float().T) * scale


def flash_attention_plain(q, k, v, causal=True, window=None, scale=1.0,
                          return_lse=False, round_scores=False):
    """The plain PyTorch version, one (batch, kv-head group) at a time so
    that no ``[B, H, Sq, Sk]`` score tensor is ever held: f32 scores (with
    ``round_scores`` each q·k rounded to q's dtype before the scale),
    ``-inf`` where masked, softmax, NaN rows (no key kept) to 0, p rounded
    to q's dtype, f32 product with v."""
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    keep = keep_mask(torch.arange(sq, device=q.device),
                     torch.arange(sk, device=q.device), causal, window)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for bi in range(b):
        for g in range(hkv):
            heads = slice(g * rep, (g + 1) * rep)
            s = _scores(q[bi, heads], k[bi, g], scale, round_scores)
            s = s.masked_fill(~keep, -torch.inf)
            row = torch.logsumexp(s, dim=-1)
            lse[bi, heads] = torch.where(torch.isinf(row), torch.inf, row)
            p = torch.softmax(s, dim=-1)
            p = torch.where(torch.isnan(p), 0.0, p).to(q.dtype).float()
            out[bi, heads] = (p @ v[bi, g].float()).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True, window=None,
                              scale=1.0, round_scores=False):
    """The plain PyTorch backward, one (batch, kv-head group) at a time, the
    JAX package's ``_flash_bwd`` in float32: ``delta = rowsum(dO·O)``,
    ``P = exp(scale·q·k − lse)`` where kept (q·k rounded as the forward
    rounds it under ``round_scores``), ``dV = Pᵀ·dO``, ``dP = dO·Vᵀ``,
    ``dS = P·(dP − delta)·scale``, ``dQ = dS·K``, ``dK = dSᵀ·Q``, the
    group's heads summed onto their kv head; results in the inputs' dtype."""
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    keep = keep_mask(torch.arange(sq, device=q.device),
                     torch.arange(sk, device=q.device), causal, window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for bi in range(b):
        for g in range(hkv):
            heads = slice(g * rep, (g + 1) * rep)
            qf, kf, vf = q[bi, heads].float(), k[bi, g].float(), v[bi, g].float()
            do = dout[bi, heads].float()
            delta = (do * out[bi, heads].float()).sum(dim=-1)
            s = _scores(q[bi, heads], k[bi, g], scale, round_scores)
            p = torch.where(keep, torch.exp(s - lse[bi, heads][..., None]), 0.0)
            ds = p * (do @ vf.T - delta[..., None]) * scale
            dv[bi, g] = (p.transpose(-1, -2) @ do).sum(dim=0).to(v.dtype)
            dq[bi, heads] = (ds @ kf).to(q.dtype)
            dk[bi, g] = (ds.transpose(-1, -2) @ qf).sum(dim=0).to(k.dtype)
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
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    """The C entry point of the backward kernels' library, typed."""
    fn = build.library("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [
        ctypes.c_int, *[ctypes.c_void_p] * 12, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
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
    if route(q.dtype, d) == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core route needs q, k and v 16-byte aligned")


def flash_attention(q, k, v, causal=True, window=None, scale=1.0, return_lse=False,
                    round_scores=False):
    """Attention on the card by ``csrc/flash_attention.cu``; see module."""
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal, window, scale, return_lse,
                                     round_scores)
    _check(q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    rc = _entry()(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, h, k.shape[1], sq, k.shape[2], d,
        _DTYPE_CODE[q.dtype], int(bool(causal)), int(window is not None),
        0 if window is None else int(window), float(scale), int(bool(round_scores)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    if route(q.dtype, d) == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_simt += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_simt = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=None, scale=1.0,
                        round_scores=False):
    """``(dq, dk, dv)`` of :func:`flash_attention` on the card by
    ``csrc/flash_attention_bwd.cu`` (the plain version for CPU tensors):
    ``out`` and ``lse`` from the forward with ``return_lse=True`` and the
    same ``round_scores``, ``dout`` the output's cotangent ``[B, H, Sq,
    D]``. The tensor-core route takes its scratch from ``torch.empty``:
    an f32 dQ accumulator ``[B·H, ⌈Sq/64⌉, 64, D rounded up to 16]`` (168
    MB at h2o-danube's training shape) beside f32 rows and int32 counters."""
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, window, scale,
                                         round_scores)
    _check(q, k, v)
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
    rc = _bwd_entry()(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
        None if acc is None else acc.data_ptr(),
        None if counters is None else counters.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], sq, k.shape[2], d,
        _DTYPE_CODE[q.dtype], int(bool(causal)), int(window is not None),
        0 if window is None else int(window), float(scale), int(bool(round_scores)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    if tc:
        flash_attention_bwd.launches_tc += 1
    else:
        flash_attention_bwd.launches_simt += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0
flash_attention_bwd.launches_simt = 0
