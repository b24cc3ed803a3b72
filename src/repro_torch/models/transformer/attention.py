"""Attention: GQA + RoPE + qk-norm + sliding window; dense and flash paths.

The forward half of ``repro.models.transformer.attention``, layout
``[B, S, H, Dh]`` as there:

* :func:`attention_dense` — scores over every key, with explicit positions
  and a key mask: the decode step's ring-buffer attention, plain tensor
  code as in the JAX package;
* :func:`attention_chunked` — the prefill/forward attention. Where the JAX
  package runs an online softmax over KV chunks in ``lax.scan``, the port
  calls ``kernels.flash_attention``, which computes that online softmax in
  one CUDA kernel on the card (its plain version on the CPU). Its gradient
  is the JAX package's custom VJP (``_flash_fwd`` saves the logsumexp,
  ``_flash_bwd`` recomputes P from it): ``kernels.autograd.flash_attention``,
  whose backward is the kernel of ``csrc/flash_attention_bwd.cu``.

One difference is kept on purpose: a query row with no key kept gives 0
from the kernel, where ``attention_chunked`` in the JAX package gives the
mean of V (its mask value ``NEG_INF`` is a finite −1e30). Causal prefill
from position 0 keeps at least the query's own key, so no model path meets
such a row; there the backward gives a zero gradient.
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


def attention_chunked(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention over positions 0..S−1 (those of a forward or a
    prefill), scaled by ``Dh**-0.5``: one ``kernels.flash_attention`` call
    in its ``[B, H, S, Dh]`` layout, each q·k rounded to the inputs' dtype
    before the scale (``round_scores``), as the JAX package's bf16 einsum
    rounds its scores and the decode step's ``attention_dense`` does."""
    out = flash_attention(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=causal,
        window=window,
        scale=q.shape[-1] ** -0.5,
        round_scores=True,
    )
    return out.transpose(1, 2)


def attention(q, k, v, q_pos, k_pos, cfg, causal=True, kv_mask=None):
    """The JAX package's dispatch: one query (decode) or ``attn_impl ==
    "dense"`` takes :func:`attention_dense`; a sequence takes
    :func:`attention_chunked`, whose positions are 0..S−1 — the ones
    ``forward`` and ``prefill`` pass — and which takes no key mask."""
    window = cfg.swa_window
    if cfg.attn_impl == "dense" or q.shape[1] == 1:
        return attention_dense(
            q, k, v, q_pos, k_pos, causal=causal, window=window, kv_mask=kv_mask
        )
    if kv_mask is not None or q_pos.ndim != 1 or q_pos.shape != k_pos.shape:
        raise NotImplementedError(
            "the flash path takes positions 0..S-1 of one sequence and no key mask"
        )
    return attention_chunked(q, k, v, causal=causal, window=window)
