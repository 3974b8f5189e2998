"""Attention primitives (port of ops/attention.py).

``mha_attention`` is the plain PyTorch attention of every model call:
decoder self- and cross-attention in the teacher-forced forward,
cross-attention in the decode step, and the decode step's self-attention
when the decode-step kernel is off.  Layout ``[B, T, H, Dh]``
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def mha_attention(
    q: torch.Tensor,             # [B, Tq, H, Dh]
    k: torch.Tensor,             # [B, Tk, H, Dh]
    v: torch.Tensor,             # [B, Tk, H, Dh]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Tq, Tk], True=keep
) -> torch.Tensor:
    """Scaled dot-product multi-head attention. Returns [B, Tq, H, Dh].

    Masked scores take ``finfo.min``, as the JAX function does, so a row
    with every key masked gets uniform weights instead of NaN."""
    # 1/sqrt(Dh) in q's dtype, as jnp.sqrt(jnp.asarray(dh, q.dtype)), filled
    # on the device (a copy from the host would wait for the device)
    scale = 1.0 / torch.full((), q.shape[-1], dtype=q.dtype, device=q.device).sqrt()
    scores = torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', probs, v)


def causal_mask(seq_len: int, device: str | torch.device = 'cpu') -> torch.Tensor:
    """[1, 1, T, T] lower-triangular keep-mask."""
    m = torch.ones(seq_len, seq_len, dtype=torch.bool, device=device).tril()
    return m[None, None]
