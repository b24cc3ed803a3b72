"""Attention: GQA + RoPE + qk-norm + sliding window; dense and flash paths.

The forward half of ``repro.models.transformer.attention``, layout
``[B, S, H, Dh]`` as there:

* :func:`attention_dense` — scores over every key, with explicit positions
  and a key mask: the decode step's ring-buffer attention, plain tensor
  code as in the JAX package;
* :func:`attention_partial` — the decode step's attention under tensor
  parallelism: each rank attends over its own block of the cache's slots,
  the softmax normalised by the log-sum-exp over every block (reduced over
  the ``model`` ranks in float32) and the blocks' ``P·V`` summed over the
  ranks in float32;
* :func:`attention_chunked` — the prefill/forward attention. Where the JAX
  package runs an online softmax over KV chunks in ``lax.scan``, the port
  calls ``kernels.flash_attention``, which computes that online softmax in
  one CUDA kernel on the card (its plain version on the CPU). Its gradient
  is the JAX package's custom VJP (``_flash_fwd`` saves the logsumexp,
  ``_flash_bwd`` recomputes P from it): ``kernels.autograd.flash_attention``,
  whose backward is the kernel of ``csrc/flash_attention_bwd.cu``.

:func:`attention_chunked` takes the JAX package's arguments whole: query
and key positions (``[S]`` or ``[B, S]``) and a key mask ``[B, Sk]``. With
none of them its positions are 0..S−1 — what ``forward`` and ``prefill``
pass (``None`` through :func:`attention`) — and the kernel runs its index
route, whose rows always keep a key there. Any positions or mask given
take the kernel's positions route, which reads them on the card (no host
sync) and follows the JAX package where a row keeps no key: its finite
mask value ``NEG_INF`` (−1e30) gives such a row ``Σ_{j<Sk} v_j / (Sk +
pad)``, the pad being the zero keys of JAX's last KV chunk, and in the
backward a probability of 1 for every key.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.autograd import flash_attention
from repro_torch.kernels.flash_attention import keep_mask

NEG_INF = -1e30


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE. x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # [Dh/2]
    angles = positions[..., None].float() * freqs  # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, Dh] → [B, S, Hkv*n_rep, Dh] (GQA broadcast)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """Additive mask bias [..., Sq, Sk] from position vectors."""
    return torch.where(keep_mask(q_pos, k_pos, causal, window), 0.0, NEG_INF)


def attention_dense(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, Hkv, Dh]
    v: torch.Tensor,  # [B, Sk, Hkv, Dh]
    q_pos: torch.Tensor,  # [B, Sq] or [Sq]
    k_pos: torch.Tensor,  # [B, Sk] or [Sk]
    causal: bool = True,
    window: Optional[int] = None,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Sk] valid-KV mask (decode)
) -> torch.Tensor:
    dh = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * dh**-0.5
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    if k_pos.ndim == 1:
        k_pos = k_pos[None]
    logits = logits + _mask_bias(q_pos[:, None, :], k_pos[:, None, :], causal, window)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_partial(q, k, v, q_pos, k_pos, group, causal: bool = True,
                      window: Optional[int] = None, kv_mask: Optional[torch.Tensor] = None):
    """:func:`attention_dense` with the keys split over ``group``'s ranks,
    ``k``/``v`` this rank's block: the softmax normalised over every block
    (its max and its sum of exponentials reduced over the ranks in
    float32), the probabilities rounded to ``q``'s dtype as there, and this
    block's ``P·V`` accumulated in float32 and summed over the ranks.
    Returns ``[B, Sq, H, Dh]`` float32, for the caller to round once."""
    from repro_torch.dist import collectives as coll

    dh = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * dh**-0.5
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    if k_pos.ndim == 1:
        k_pos = k_pos[None]
    logits = logits + _mask_bias(q_pos[:, None, :], k_pos[:, None, :], causal, window)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, NEG_INF)
    e = torch.exp(logits - coll.pmax(logits.amax(dim=-1), group)[..., None])
    probs = (e / coll.psum(e.sum(dim=-1), group)[..., None]).to(q.dtype)
    return coll.psum(_pv_float32(probs, v), group)


def _pv_float32(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``P [B, H, Sq, Sk] · V [B, Sk, H, Dh]`` → ``[B, Sq, H, Dh]``,
    accumulated and returned in float32 (bf16 operands unrounded: the
    card's ``bmm`` with a float32 output, upcast operands on the CPU)."""
    from torch._subclasses.fake_tensor import FakeTensor

    b, h, sq, sk = probs.shape
    p = probs.reshape(b * h, sq, sk)
    vt = v.permute(0, 2, 1, 3).reshape(b * h, sk, v.shape[-1])
    if probs.dtype == torch.float32:
        out = torch.bmm(p, vt)
    elif probs.is_cuda or isinstance(probs, FakeTensor):
        out = torch.bmm(p, vt, out_dtype=torch.float32)
    else:
        out = torch.bmm(p.float(), vt.float())
    return out.reshape(b, h, sq, -1).transpose(1, 2)


def _positions(pos, b: int, s: int, device) -> torch.Tensor:
    """int32 ``[B, S]`` from ``[S]``, ``[B, S]`` or ``None`` (0..S−1)."""
    if pos is None:
        pos = torch.arange(s, dtype=torch.int32, device=device)
    return pos.to(torch.int32).expand(b, s).contiguous()


def attention_chunked(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, Hkv, Dh]
    v: torch.Tensor,
    q_pos: Optional[torch.Tensor] = None,  # [B, Sq] or [Sq]; None: 0..Sq−1
    k_pos: Optional[torch.Tensor] = None,  # [B, Sk] or [Sk]; None: 0..Sk−1
    causal: bool = True,
    window: Optional[int] = None,
    chunk_q: int = 1024,  # kept for API compat, as in JAX; unused
    chunk_kv: int = 1024,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Sk] valid-KV mask
) -> torch.Tensor:
    """Flash attention scaled by ``Dh**-0.5``: one ``kernels.flash_attention``
    call in its ``[B, H, S, Dh]`` layout, each q·k rounded to the inputs'
    dtype before the scale (``round_scores``), as the JAX package's bf16
    einsum rounds its scores and the decode step's ``attention_dense``
    does. Without positions and mask, where every row keeps a key (Sq ≤ Sk
    and a window of at least 1), the kernel's index route; otherwise its
    positions route, with ``chunk_kv`` setting only the pad that JAX's
    last chunk adds to a row that keeps no key."""
    b, sq = q.shape[:2]
    sk = k.shape[1]
    extra = {}
    if not (q_pos is None and k_pos is None and kv_mask is None and sq <= sk
            and (window is None or window >= 1)):
        extra = dict(
            q_pos=_positions(q_pos, b, sq, q.device),
            k_pos=_positions(k_pos, b, sk, q.device),
            kv_mask=(torch.ones((b, sk), dtype=torch.bool, device=q.device)
                     if kv_mask is None else kv_mask.to(torch.bool).contiguous()),
            pad=(-sk) % min(chunk_kv, sk) if sk else 0,
        )
    out = flash_attention(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=causal,
        window=window,
        scale=q.shape[-1] ** -0.5,
        round_scores=True,
        **extra,
    )
    return out.transpose(1, 2)


def attention(q, k, v, q_pos, k_pos, cfg, causal=True, kv_mask=None):
    """The JAX package's dispatch: one query (decode) or ``attn_impl ==
    "dense"`` takes :func:`attention_dense`, a sequence
    :func:`attention_chunked`, with every argument passed through.
    Positions ``None`` mean 0..S−1 (the model's forward and prefill)."""
    window = cfg.swa_window
    if cfg.attn_impl == "dense" or q.shape[1] == 1:
        b = q.shape[0]
        return attention_dense(
            q, k, v,
            _positions(q_pos, b, q.shape[1], q.device) if q_pos is None else q_pos,
            _positions(k_pos, b, k.shape[1], q.device) if k_pos is None else k_pos,
            causal=causal, window=window, kv_mask=kv_mask,
        )
    return attention_chunked(q, k, v, q_pos, k_pos, causal=causal, window=window,
                             chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
                             kv_mask=kv_mask)
