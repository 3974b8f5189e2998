"""DETR-style set-prediction decoder (port of models/set_decoder.py).

12 learned slot queries run through pre-LN layers of self-attention,
cross-attention over ``n_z_tokens`` tokens projected from the latent z,
and an exact-GELU feed-forward (dropout on its branch only); a final
LayerNorm, then an element head [B, 12, 119] (class 0 = empty, 1..118 =
atomic number), a softplus fraction head and a presence head.  It runs
beside the formula decoder on the same z and is trained by
``ops/hungarian.py``'s matching loss.

The submodules carry the flax names (``z_proj``, ``slot_queries``,
``layer_i`` with ``self_{q,k,v,o}``, ``cross_{q,k,v,o}``, ``Dense_0``,
``Dense_1``, ``LayerNorm_{0,1,2}``, then ``LayerNorm_0``, the three heads),
so ``checkpoint/from_jax.py`` maps a flax tree one to one.  ``dtype`` is
the compute dtype, as flax's; the parameters are float32
(models/layers.py).  ``dropout`` is the module's own, 0.1 by default, as
in JAX, where the train step does not pass the model config's.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha_attention
from ..utils.device import resolve_device
from .layers import Dense, LayerNorm
from .layers import gelu as _gelu


class SetDecoderLayer(nn.Module):
    """Pre-LN self-attention over the slots, cross-attention to the z
    tokens, and a GELU feed-forward whose output takes dropout."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.d_model, self.nhead, self.dropout = d_model, nhead, dropout
        for name in ('self', 'cross'):
            for part in 'qkvo':
                self.add_module(f'{name}_{part}', Dense(d_model, d_model, **kw))
        self.Dense_0 = Dense(d_model, dim_feedforward, **kw)
        self.Dense_1 = Dense(dim_feedforward, d_model, **kw)
        for i in range(3):
            self.add_module(f'LayerNorm_{i}', LayerNorm(d_model, **kw))

    def _mha(self, name: str, q_in, kv_in):
        b = q_in.shape[0]
        h, hd = self.nhead, self.d_model // self.nhead
        q = getattr(self, f'{name}_q')(q_in).reshape(b, -1, h, hd)
        k = getattr(self, f'{name}_k')(kv_in).reshape(b, -1, h, hd)
        v = getattr(self, f'{name}_v')(kv_in).reshape(b, -1, h, hd)
        o = mha_attention(q, k, v).reshape(b, -1, self.d_model)
        return getattr(self, f'{name}_o')(o)

    def forward(self, slots, memory):
        x = self.LayerNorm_0(slots)
        slots = slots + self._mha('self', x, x)          # the slots coordinate
        x = self.LayerNorm_1(slots)
        slots = slots + self._mha('cross', x, memory)    # read the latent memory
        y = self.Dense_1(_gelu(self.Dense_0(self.LayerNorm_2(slots))))
        return slots + F.dropout(y, self.dropout, self.training)


class SetFormulaDecoder(nn.Module):
    """z [B, latent_dim] -> element logits [B, n_slots, n_elements + 1],
    fractions [B, n_slots] (softplus) and presence logits [B, n_slots].
    Built on ``device`` (default CUDA; raises if it is absent)."""

    def __init__(self, latent_dim: int = 2048, d_model: int = 512, nhead: int = 8,
                 num_layers: int = 3, dim_feedforward: int = 1024, n_slots: int = 12,
                 n_elements: int = 118, n_z_tokens: int = 4, dropout: float = 0.1,
                 device='cuda', dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.dtype, self.d_model = dtype, d_model
        self.n_slots, self.n_z_tokens, self.num_layers = n_slots, n_z_tokens, num_layers
        self.z_proj = Dense(latent_dim, d_model * n_z_tokens, **kw)
        self.slot_queries = nn.Parameter(torch.zeros(n_slots, d_model, device=device))
        for i in range(num_layers):
            self.add_module(f'layer_{i}', SetDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, **kw))
        self.LayerNorm_0 = LayerNorm(d_model, **kw)
        self.element_head = Dense(d_model, n_elements + 1, **kw)
        self.fraction_head = Dense(d_model, 1, **kw)
        self.presence_head = Dense(d_model, 1, **kw)

    def forward(self, z) -> Dict[str, torch.Tensor]:
        b = z.shape[0]
        mem = self.z_proj(z.to(self.dtype)).reshape(b, self.n_z_tokens, self.d_model)
        slots = self.slot_queries[None].expand(b, self.n_slots, self.d_model).to(self.dtype)
        for i in range(self.num_layers):
            slots = getattr(self, f'layer_{i}')(slots, mem)
        slots = self.LayerNorm_0(slots)
        return {
            'element_logits': self.element_head(slots),                    # [B, 12, 119]
            'fraction_pred': F.softplus(self.fraction_head(slots))[..., 0],  # [B, 12]
            'presence_logits': self.presence_head(slots)[..., 0],          # [B, 12]
        }
