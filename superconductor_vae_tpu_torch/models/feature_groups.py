"""Grouped-feature attention encoders, the contrastive-era legacy
components (port of models/feature_groups.py): per-group projections and
cross-group multi-head attention (``GroupedFeatureEncoder``), a
learnable-query expert attention over groups (``ExpertAttentionHead``,
``AttentiveExpert``) and the InfoNCE-style ``ContrastiveFeatureEncoder``.
The main training path does not use them.

Every group's ``Linear`` and ``LayerNorm`` exist from ``__init__``,
whatever groups a call supplies (flax creates a group's parameters on the
first call that supplies it); a group absent from a call, or given as
None, contributes a zero row.  The cross-group attention is flax's
``MultiHeadDotProductAttention`` written out (``MultiHeadDotProductAttention``
below): q, k and v projections to ``n_heads`` x ``hidden / n_heads``, q
scaled by 1/sqrt(head width), a float32 softmax, an output projection.
GELU is flax's default, the tanh approximation; LayerNorm's epsilon is
flax's default, 1e-6.  Dropout acts in train mode only.  The modules are built on the card
unless given ``device='cpu'``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ['DEFAULT_GROUP_DIMS', 'EXTENDED_GROUP_DIMS',
           'MultiHeadDotProductAttention', 'GroupedFeatureEncoder',
           'ExpertAttentionHead', 'AttentiveExpert', 'ContrastiveFeatureEncoder']

DEFAULT_GROUP_DIMS = {'composition': 118, 'element_stats': 22}
EXTENDED_GROUP_DIMS = {'composition': 118, 'element_stats': 22,
                       'structure': 12, 'electronic': 8,
                       'thermodynamic': 4, 'experimental': 6}

FLAX_LN_EPS = 1e-6


def _gelu(x):
    return F.gelu(x, approximate='tanh')      # flax's nn.gelu default


class MultiHeadDotProductAttention(nn.Module):
    """Self- or cross-attention with flax's parameter layout flattened
    into ``Linear``s: ``query``, ``key``, ``value`` [H*Dh, in] and ``out``
    [out, H*Dh]."""

    def __init__(self, features: int, num_heads: int, dropout: float = 0.0,
                 device=None, dtype=torch.float32):
        super().__init__()
        if features % num_heads:
            raise ValueError(f'{features} features do not split into {num_heads} heads')
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        for name in ('query', 'key', 'value', 'out'):
            self.add_module(name, nn.Linear(features, features, **kw))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor) -> torch.Tensor:
        b, tq, _ = x_q.shape
        h = self.num_heads
        q = self.query(x_q).unflatten(-1, (h, -1))
        k = self.key(x_kv).unflatten(-1, (h, -1))
        v = self.value(x_kv).unflatten(-1, (h, -1))
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum('bqhd,bkhd->bhqk', q, k).float(), dim=-1).to(q.dtype)
        w = self.dropout(w)
        return self.out(torch.einsum('bhqk,bkhd->bqhd', w, v).reshape(b, tq, -1))


class GroupedFeatureEncoder(nn.Module):
    """Cross-group attention over semantically grouped features: each
    group projects to ``hidden_dim``; the groups stack to [B, G, H]; one
    attention layer, residual and LayerNorm; flatten and an MLP."""

    def __init__(self, group_dims: Mapping[str, int], hidden_dim: int = 128,
                 n_heads: int = 4, dropout: float = 0.1, device='cuda',
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.group_dims = dict(group_dims)
        self.hidden_dim = hidden_dim
        for name, dim in self.group_dims.items():
            self.add_module(f'enc_{name}', nn.Linear(dim, hidden_dim, **kw))
            self.add_module(f'ln_{name}', nn.LayerNorm(hidden_dim, eps=FLAX_LN_EPS, **kw))
        self.drop = nn.Dropout(dropout)
        self.cross_attention = MultiHeadDotProductAttention(hidden_dim, n_heads, dropout, **kw)
        self.attention_norm = nn.LayerNorm(hidden_dim, eps=FLAX_LN_EPS, **kw)
        self.out1 = nn.Linear(len(self.group_dims) * hidden_dim, hidden_dim * 2, **kw)
        self.out2 = nn.Linear(hidden_dim * 2, hidden_dim, **kw)

    def forward(self, groups: Mapping[str, Optional[torch.Tensor]],
                return_attention: bool = False):
        given = [v for v in groups.values() if v is not None]
        b = given[0].shape[0]
        encoded = []
        for name in self.group_dims:
            g = groups.get(name)
            if g is None:
                encoded.append(given[0].new_zeros(b, self.hidden_dim))
                continue
            h = getattr(self, f'ln_{name}')(getattr(self, f'enc_{name}')(g))
            encoded.append(self.drop(_gelu(h)))
        x = torch.stack(encoded, dim=1)                      # [B, G, H]
        attended = self.attention_norm(self.cross_attention(x, x) + x)
        y = self.drop(_gelu(self.out1(attended.reshape(b, -1))))
        out = self.out2(y)
        if return_attention:
            # the mean attention map, for interpretability
            w = torch.einsum('bgh,bkh->bgk', attended, attended) / math.sqrt(self.hidden_dim)
            return out, torch.softmax(w, dim=-1)
        return out


class ExpertAttentionHead(nn.Module):
    """Learnable-query soft attention over feature groups: which groups
    this expert reads.  ``in_dim`` is the group embeddings' width
    (default ``hidden_dim``)."""

    def __init__(self, hidden_dim: int, temperature: float = 1.0,
                 in_dim: Optional[int] = None, device='cuda', dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.temperature = temperature
        self.query = nn.Parameter(torch.randn(hidden_dim, device=device, dtype=dtype))
        self.key_proj = nn.Linear(in_dim or hidden_dim, hidden_dim, device=device, dtype=dtype)

    def forward(self, group_embeddings: torch.Tensor) -> torch.Tensor:
        scores = self.key_proj(group_embeddings) @ self.query / self.temperature   # [..., G]
        return torch.softmax(scores, dim=-1)


class AttentiveExpert(nn.Module):
    """An expert MLP over its attention-weighted mixture of groups;
    returns (output, weights)."""

    def __init__(self, hidden_dim: int, output_dim: int = 1, temperature: float = 1.0,
                 in_dim: Optional[int] = None, device='cuda', dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        in_dim = in_dim or hidden_dim
        self.attention = ExpertAttentionHead(hidden_dim, temperature, in_dim, **kw)
        self.fc1 = nn.Linear(in_dim, hidden_dim, **kw)
        self.fc2 = nn.Linear(hidden_dim, output_dim, **kw)

    def forward(self, group_embeddings: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.attention(group_embeddings)
        mixed = torch.einsum('bg,bgh->bh', w, group_embeddings)
        return self.fc2(_gelu(self.fc1(mixed))), w


class ContrastiveFeatureEncoder(nn.Module):
    """MLP encoder and projection head for SC / non-SC contrastive
    learning."""

    def __init__(self, input_dim: int, latent_dim: int = 64,
                 hidden_dims: Sequence[int] = (256, 128), temperature: float = 0.07,
                 dropout: float = 0.1, device='cuda', dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.temperature = temperature
        self.n_hidden = len(hidden_dims)
        prev = input_dim
        for i, h in enumerate(hidden_dims):
            self.add_module(f'enc_{i}', nn.Linear(prev, h, **kw))
            self.add_module(f'enc_ln_{i}', nn.LayerNorm(h, eps=FLAX_LN_EPS, **kw))
            prev = h
        self.enc_out = nn.Linear(prev, latent_dim, **kw)
        self.proj1 = nn.Linear(latent_dim, latent_dim, **kw)
        self.proj2 = nn.Linear(latent_dim, latent_dim, **kw)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            norm, dense = getattr(self, f'enc_ln_{i}'), getattr(self, f'enc_{i}')
            x = self.drop(_gelu(norm(dense(x))))
        return self.enc_out(x)

    def encode_project(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z, its normalised projection) in one pass."""
        z = self(x)
        return z, self.project(z)

    def project(self, z: torch.Tensor) -> torch.Tensor:
        p = self.proj2(_gelu(self.proj1(z)))
        return p / p.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    def contrastive_loss(self, z_sc: torch.Tensor, z_neg: torch.Tensor) -> torch.Tensor:
        """Pushes each SC row's best SC neighbour above all negatives:
        mean(-max_pos_sim + logsumexp(neg_sims))."""
        p_sc, p_neg = self.project(z_sc), self.project(z_neg)
        sim_ss = p_sc @ p_sc.T / self.temperature                # [S, S]
        sim_sn = p_sc @ p_neg.T / self.temperature               # [S, N]
        eye = torch.eye(p_sc.shape[0], dtype=torch.bool, device=p_sc.device)
        max_pos = sim_ss.masked_fill(eye, float('-inf')).amax(dim=1)
        return (-max_pos + torch.logsumexp(sim_sn, dim=1)).mean()

