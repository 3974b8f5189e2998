"""Legacy model families, kept for capability (port of models/legacy.py):

- ``BidirectionalVAE``: the Magpie-feature VAE of the first model
  generation: a stochastic encoder with reparameterisation, a feature
  decoder, a Tc predictor, a competence head, and its ELBO-style loss.
- ``PointerGeneratorDecoder``: copy-versus-generate decoding, with copy
  attention over the input element tokens and a learned gate.

Neither is wired into the main training path.  The submodules carry the
flax names (``enc_0``, ``fc_mean``, ``tc_head_0`` ...), so that
``checkpoint/from_jax.py`` maps a flax tree onto them leaf by leaf.  The
VAE samples z from a ``torch.Generator`` (or from noise the caller
passes); the decoder's causal self-attention is the plain
``ops/attention.py`` ``mha_attention``, as in the JAX package.  GELU is
exact (erf); LayerNorm's epsilon is flax's default, 1e-6.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import causal_mask, mha_attention
from ..utils.device import resolve_device
from .feature_groups import FLAX_LN_EPS


def _gelu(x):
    return F.gelu(x)


class BidirectionalVAE(nn.Module):
    """Magpie-feature VAE with Tc prediction and competence heads."""

    def __init__(self, feature_dim: int = 145, hidden_dims: Tuple[int, ...] = (256, 128),
                 latent_dim: int = 64, dropout: float = 0.1, device='cuda',
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.dropout = dropout            # kept for the config; no layer uses it
        prev = feature_dim
        self.n_enc = len(hidden_dims)
        for i, h in enumerate(hidden_dims):
            self.add_module(f'enc_{i}', nn.Linear(prev, h, **kw))
            prev = h
        self.fc_mean = nn.Linear(prev, latent_dim, **kw)
        self.fc_logvar = nn.Linear(prev, latent_dim, **kw)
        dec_dims = tuple(reversed(hidden_dims)) + (feature_dim,)
        self.n_dec = len(dec_dims)
        prev = latent_dim
        for i, h in enumerate(dec_dims):
            self.add_module(f'dec_{i}', nn.Linear(prev, h, **kw))
            prev = h
        self.tc_head_0 = nn.Linear(latent_dim, 64, **kw)
        self.tc_head_1 = nn.Linear(64, 1, **kw)
        self.competence_head_0 = nn.Linear(latent_dim, 32, **kw)
        self.competence_head_1 = nn.Linear(32, 1, **kw)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for i in range(self.n_enc):
            h = _gelu(getattr(self, f'enc_{i}')(h))
        return self.fc_mean(h), self.fc_logvar(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for i in range(self.n_dec - 1):
            h = _gelu(getattr(self, f'dec_{i}')(h))
        return getattr(self, f'dec_{self.n_dec - 1}')(h)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample: bool = True, noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """z = mean + std * eps when ``sample`` and there is a source of eps
        (``noise``, or a draw from ``generator``); else z = mean."""
        mean, logvar = self.encode(x)
        if sample and (noise is not None or generator is not None):
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                    dtype=mean.dtype)
            z = mean + torch.exp(0.5 * logvar) * noise
        else:
            z = mean
        recon = self.decode(z)
        tc = self.tc_head_1(_gelu(self.tc_head_0(z)))[:, 0]
        comp = torch.sigmoid(self.competence_head_1(_gelu(self.competence_head_0(z))))[:, 0]
        return {'recon': recon, 'z': z, 'z_mean': mean, 'z_logvar': logvar,
                'tc_pred': tc, 'competence': comp}

    @staticmethod
    def loss(out: Dict[str, torch.Tensor], x: torch.Tensor, tc_true: torch.Tensor,
             beta: float = 1e-3, tc_weight: float = 1.0) -> Dict[str, torch.Tensor]:
        recon = ((out['recon'] - x) ** 2).mean()
        kl = -0.5 * torch.mean(1 + out['z_logvar'] - out['z_mean'] ** 2
                               - torch.exp(out['z_logvar']))
        tc = ((out['tc_pred'] - tc_true) ** 2).mean()
        total = recon + beta * kl + tc_weight * tc
        return {'total': total, 'recon': recon, 'kl': kl, 'tc': tc}


class PointerGeneratorDecoder(nn.Module):
    """Copy-versus-generate decoder: the vocab distribution blended with a
    copy distribution over the input element tokens by a learned gate."""

    def __init__(self, vocab_size: int, d_model: int = 128, nhead: int = 4,
                 max_src: int = 12, device='cuda', dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.vocab_size, self.d_model, self.nhead, self.max_src = vocab_size, d_model, nhead, max_src
        self.embed = nn.Embedding(vocab_size, d_model, **kw)
        for name in ('q', 'k', 'v', 'cq', 'ck'):
            self.add_module(name, nn.Linear(d_model, d_model, **kw))
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS, **kw)
        self.gen = nn.Linear(2 * d_model, vocab_size, **kw)
        self.gate = nn.Linear(2 * d_model, 1, **kw)
        nn.init.normal_(self.embed.weight, std=0.02)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, src_tokens: torch.Tensor, src_mask: torch.Tensor,
                tgt_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``src_tokens`` [B, S] element token ids, ``tgt_tokens`` [B, T]
        teacher inputs; returns the mixture's log-probabilities [B, T, V],
        the gate p_gen [B, T] and the copy attention [B, T, S]."""
        b, s = src_tokens.shape
        t = tgt_tokens.shape[1]
        d, h = self.d_model, self.nhead
        src, tgt = self.embed(src_tokens), self.embed(tgt_tokens)

        q = self.q(tgt).reshape(b, t, h, d // h)
        k = self.k(tgt).reshape(b, t, h, d // h)
        v = self.v(tgt).reshape(b, t, h, d // h)
        hidden = mha_attention(q, k, v, causal_mask(t, tgt.device)).reshape(b, t, d)
        hidden = self.LayerNorm_0(tgt + hidden)

        scores = torch.einsum('btd,bsd->bts', self.cq(hidden), self.ck(src)) / math.sqrt(d)
        scores = scores.masked_fill(~src_mask.bool()[:, None, :], -1e30)
        copy_attn = torch.softmax(scores, dim=-1)                 # [B, T, S]
        context = torch.einsum('bts,bsd->btd', copy_attn, src)

        hc = torch.cat([hidden, context], dim=-1)
        gen_probs = torch.softmax(self.gen(hc), dim=-1)
        p_gen = torch.sigmoid(self.gate(hc))                      # [B, T, 1]
        onehot = F.one_hot(src_tokens, self.vocab_size).to(copy_attn.dtype)
        copy_probs = torch.einsum('bts,bsv->btv', copy_attn, onehot)
        mix = p_gen * gen_probs + (1.0 - p_gen) * copy_probs
        return {'log_probs': torch.log(mix.clamp_min(1e-9)),
                'p_gen': p_gen[..., 0], 'copy_attention': copy_attn}
