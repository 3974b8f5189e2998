"""Multi-task materials encoder (port of models/encoder.py).

Three input branches (stoichiometry-weighted element attention, Magpie
MLP, Tc embedding) fuse into a deterministic latent ``z``, decoded by a
shared backbone into the prediction heads: Tc residual head, Magpie,
attended conditioning, competence, fractions + count, high pressure, Tc
bucket, cross-head SC classifier and the 3-level family head.

Submodules carry the names of the flax modules they port (``Dense_0``,
``LayerNorm_0``, ``tc_encoder_pre``, ...), so a flax parameter path is
also the module path here (checkpoint/from_jax.py).  Exact (erf) GELU and
LayerNorm eps 1e-5, as in the JAX package.  ``dtype`` is the compute
dtype, as flax's: the parameters are float32 whatever it is
(models/layers.py).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .config import ModelConfig
from .layers import PARAM_DTYPE, Dense, Embed, LayerNorm
from .layers import gelu as _gelu


class MLP(nn.Module):
    """[Linear -> LayerNorm? -> GELU -> Dropout?] stack used across branches."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 use_layernorm: bool = True, dropout: float = 0.0,
                 final_activation: bool = True, device=None, dtype=torch.float32):
        super().__init__()
        self.n = len(features)
        self.use_layernorm = use_layernorm
        self.final_activation = final_activation
        self.dropout = dropout
        kw = dict(device=device, dtype=dtype)
        d = in_dim
        for i, f in enumerate(features):
            self.add_module(f'Dense_{i}', Dense(d, f, **kw))
            if use_layernorm and (i < self.n - 1 or final_activation):
                self.add_module(f'LayerNorm_{i}', LayerNorm(f, **kw))
            d = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f'Dense_{i}')(x)
            if i < self.n - 1 or self.final_activation:
                if self.use_layernorm:
                    x = getattr(self, f'LayerNorm_{i}')(x)
                x = _gelu(x)
                if self.dropout > 0:
                    x = F.dropout(x, self.dropout, self.training)
        return x


class ElementAttention(nn.Module):
    """Learned-query multi-head attention over the element slots; returns
    the pooled representation and the head-averaged attention weights."""

    def __init__(self, hidden_dim: int, n_heads: int, dropout: float = 0.1,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.hidden_dim, self.n_heads, self.dropout = hidden_dim, n_heads, dropout
        self.dtype = dtype
        self.query = nn.Parameter(torch.empty(n_heads, hidden_dim // n_heads,
                                              device=device, dtype=PARAM_DTYPE))
        self.key_proj = Dense(hidden_dim, hidden_dim, **kw)
        self.value_proj = Dense(hidden_dim, hidden_dim, **kw)
        self.output_proj = Dense(hidden_dim, hidden_dim, **kw)
        self.LayerNorm_0 = LayerNorm(hidden_dim, **kw)

    def forward(self, embeds, mask):
        b, n, _ = embeds.shape
        hd = self.hidden_dim // self.n_heads
        keys = self.key_proj(embeds).reshape(b, n, self.n_heads, hd)
        values = self.value_proj(embeds).reshape(b, n, self.n_heads, hd)
        scores = torch.einsum('hd,bnhd->bhn', self.query.to(self.dtype), keys)
        # torch.full fills on the device: a host scalar copied there
        # would make the host wait for the device
        scores = scores / torch.full((), hd, dtype=self.dtype,
                                     device=scores.device).sqrt()
        scores = scores.masked_fill(~mask[:, None, :],
                                    torch.finfo(self.dtype).min)
        attn = torch.softmax(scores, dim=-1)
        attn = F.dropout(attn, self.dropout, self.training)
        attended = torch.einsum('bhn,bnhd->bhd', attn, values)
        out = self.LayerNorm_0(self.output_proj(attended.reshape(b, self.hidden_dim)))
        return out, attn.mean(dim=1)            # [B, hidden], [B, n]


class ElementEncoder(nn.Module):
    """Learned element embeddings, fraction-weighted, attention-pooled."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dtype = dtype
        self.element_embed = Embed(cfg.n_elements + 1,
                                          cfg.element_embed_dim, **kw)
        self.element_attention = ElementAttention(
            cfg.element_embed_dim, cfg.n_attention_heads, cfg.dropout, **kw)
        self.output_projection = MLP(cfg.element_embed_dim, [cfg.fusion_dim],
                                     dropout=cfg.dropout, **kw)

    def forward(self, element_indices, element_fractions, element_mask):
        embeds = self.element_embed(element_indices)
        # stoichiometry weighting BEFORE attention: Cu3 counts 3x Y1
        embeds = embeds * element_fractions[..., None].to(self.dtype)
        attended, attn_w = self.element_attention(embeds, element_mask.bool())
        return self.output_projection(attended), attn_w, embeds


class HierarchicalFamilyHead(nn.Module):
    """3-level family tree conditioned on the detached P(SC); composes the
    14-class probabilities NOT_SC, BCS, 6 cuprate subs, 2 iron subs, MgB2,
    heavy fermion, organic, other."""

    _HEADS = (('coarse', (256, 128), 7), ('cuprate_sub', (128, 64), 6),
              ('iron_sub', (64,), 2))

    def __init__(self, backbone_dim: int, dropout: float = 0.1,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dropout, self.dtype = dropout, dtype
        for name, widths, out in self._HEADS:
            d = backbone_dim + 1
            for i, w in enumerate(widths):
                self.add_module(f'{name}_d{i}', Dense(d, w, **kw))
                if i == 0:
                    self.add_module(f'{name}_ln', LayerNorm(w, **kw))
                d = w
            self.add_module(f'{name}_out', Dense(d, out, **kw))

    def _head(self, x, name, n_layers):
        y = x
        for i in range(n_layers):
            y = getattr(self, f'{name}_d{i}')(y)
            if i == 0:
                y = getattr(self, f'{name}_ln')(y)
            y = _gelu(y)
            if i == 0:
                y = F.dropout(y, self.dropout, self.training)
        return getattr(self, f'{name}_out')(y)

    def forward(self, h, sc_logit_detached) -> Dict[str, torch.Tensor]:
        sc_prob = torch.sigmoid(sc_logit_detached)[:, None].to(self.dtype)
        x = torch.cat([h, sc_prob], dim=-1)
        coarse, cuprate, iron = (self._head(x, name, len(widths))
                                 for name, widths, _ in self._HEADS)
        cp = torch.softmax(coarse, dim=-1)
        cup = torch.softmax(cuprate, dim=-1)
        irp = torch.softmax(iron, dim=-1)
        p_sc = sc_prob[:, 0]
        composed = torch.cat([
            (1.0 - p_sc)[:, None],                       # 0 NOT_SC
            (p_sc * cp[:, 0])[:, None],                  # 1 BCS
            (p_sc * cp[:, 1])[:, None] * cup,            # 2-7 cuprates
            (p_sc * cp[:, 2])[:, None] * irp,            # 8-9 iron
            (p_sc * cp[:, 3])[:, None],                  # 10 MgB2
            (p_sc * cp[:, 4])[:, None],                  # 11 heavy fermion
            (p_sc * cp[:, 5])[:, None],                  # 12 organic
            (p_sc * cp[:, 6])[:, None],                  # 13 other
        ], dim=-1)
        return {'coarse_logits': coarse, 'cuprate_sub_logits': cuprate,
                'iron_sub_logits': iron, 'composed_14': composed}


class MaterialsEncoder(nn.Module):
    """Three-branch encoder -> deterministic z -> multi-head decode.

    Built on ``device`` (default CUDA; raises if it is absent), computing
    in ``dtype`` with float32 parameters.  Parameters are left to
    ``models.init.init_params`` or ``checkpoint.from_jax``."""

    def __init__(self, cfg: ModelConfig, device='cuda', dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.dtype = cfg, dtype
        f, lat, p = cfg.fusion_dim, cfg.latent_dim, cfg.dropout
        self.element_encoder = ElementEncoder(cfg, **kw)
        self.magpie_encoder = MLP(cfg.magpie_dim, [f * 2, f], dropout=p, **kw)
        # Dense -> GELU -> Dense, then LN -> GELU (reference tc_encoder)
        self.tc_encoder_pre = MLP(1, [f // 2, f], use_layernorm=False,
                                  final_activation=False, **kw)
        self.tc_encoder_ln = LayerNorm(f, **kw)
        self.fusion = MLP(3 * f, [f * 3], dropout=p, **kw)
        self.latent_mlp = MLP(3 * f, list(cfg.encoder_hidden), **kw)
        self.fc_mean = Dense(cfg.encoder_hidden[-1], lat, **kw)

        self.decoder_backbone = MLP(lat, list(cfg.decoder_hidden), dropout=p, **kw)
        bb = cfg.decoder_hidden[-1]
        self.tc_proj = Dense(bb, 256, **kw)
        self.tc_res_block = MLP(256, [256, 256], dropout=p,
                                final_activation=False, **kw)
        self.tc_out_ln = LayerNorm(256, **kw)
        self.tc_out_1 = Dense(256, 128, **kw)
        self.tc_out_2 = Dense(128, 1, **kw)
        self.magpie_head = MLP(bb, [bb, cfg.magpie_dim], use_layernorm=False,
                               final_activation=False, **kw)
        self.attended_head = Dense(bb, f, **kw)
        self.attended_head_ln = LayerNorm(f, **kw)
        self.competence_head = MLP(lat, [lat // 4, 1], use_layernorm=False,
                                   final_activation=False, **kw)
        # Dense -> LN -> GELU -> Dropout -> Dense -> GELU -> Dense
        self.fraction_d0 = Dense(lat, 256, **kw)
        self.fraction_ln = LayerNorm(256, **kw)
        self.fraction_d1 = Dense(256, 128, **kw)
        self.fraction_d2 = Dense(128, cfg.max_elements + 1, **kw)
        self.hp_d0 = Dense(lat, 256, **kw)          # ReLU head
        self.hp_d1 = Dense(256, 1, **kw)
        self.tc_class_head = MLP(bb, [256, 5], use_layernorm=False,
                                 final_activation=False, dropout=p, **kw)
        if cfg.use_numden_head:
            self.numden_head = MLP(lat, [512, 256, 24], final_activation=False,
                                   dropout=p, **kw)
        # Dense -> GELU -> LN -> Dropout -> Dense -> GELU -> Dense
        sc_in = (lat + 1 + cfg.magpie_dim + 1 + cfg.max_elements + 1 + 1 + 5)
        self.sc_d0 = Dense(sc_in, 512, **kw)
        self.sc_ln = LayerNorm(512, **kw)
        self.sc_d1 = Dense(512, 128, **kw)
        self.sc_d2 = Dense(128, 1, **kw)
        self.family_head = HierarchicalFamilyHead(bb, p, **kw)

    def _drop(self, x):
        return F.dropout(x, self.cfg.dropout, self.training)

    def encode(self, element_indices, element_fractions, element_mask,
               magpie, tc) -> Dict[str, torch.Tensor]:
        tc = tc.reshape(tc.shape[0], 1).to(self.dtype)
        elem_repr, attn_w, elem_embeds = self.element_encoder(
            element_indices, element_fractions, element_mask)
        magpie_repr = self.magpie_encoder(magpie.to(self.dtype))
        tc_repr = _gelu(self.tc_encoder_ln(self.tc_encoder_pre(tc)))
        fused = self.fusion(torch.cat([elem_repr, magpie_repr, tc_repr], dim=-1))
        z = self.fc_mean(self.latent_mlp(fused))
        return {'z': z, 'z_mean': z, 'attention_weights': attn_w,
                'element_embeddings': elem_embeds, 'fused_repr': fused}

    def fraction_heads(self, z) -> torch.Tensor:
        h = self._drop(_gelu(self.fraction_ln(self.fraction_d0(z))))
        return self.fraction_d2(_gelu(self.fraction_d1(h)))

    def decode(self, z) -> Dict[str, torch.Tensor]:
        h = self.decoder_backbone(z.to(self.dtype))
        tc_h = self.tc_proj(h)
        tc_h = tc_h + self.tc_res_block(tc_h)
        tc_pred = self.tc_out_2(
            _gelu(self.tc_out_1(_gelu(self.tc_out_ln(tc_h)))))[:, 0]
        return {
            'tc_pred': tc_pred,
            'magpie_pred': self.magpie_head(h),
            'attended_input': self.attended_head_ln(self.attended_head(h)),
            'tc_class_logits': self.tc_class_head(h),
            'backbone_h': h,
        }

    def _heads(self, z, dec) -> Dict[str, torch.Tensor]:
        """Head assembly shared by ``forward`` and ``heads_from_z``."""
        cfg = self.cfg
        competence = torch.sigmoid(self.competence_head(z)[:, 0])
        frac_out = self.fraction_heads(z)
        fraction_pred = frac_out[:, :cfg.max_elements]
        element_count_pred = frac_out[:, -1]
        hp_pred = self.hp_d1(torch.relu(self.hp_d0(z)))[:, 0]
        tc_class_logits = dec['tc_class_logits']
        # cross-head SC classifier; the input order is the checkpoint's
        sc_input = torch.cat([
            z, dec['tc_pred'][:, None], dec['magpie_pred'], hp_pred[:, None],
            fraction_pred, element_count_pred[:, None], competence[:, None],
            tc_class_logits,
        ], dim=-1)
        h_sc = self._drop(self.sc_ln(_gelu(self.sc_d0(sc_input))))
        sc_pred = self.sc_d2(_gelu(self.sc_d1(h_sc)))[:, 0]
        family = self.family_head(dec['backbone_h'], sc_pred.detach())
        return {
            'tc_pred': dec['tc_pred'], 'magpie_pred': dec['magpie_pred'],
            'tc_class_logits': tc_class_logits, 'competence': competence,
            'fraction_pred': fraction_pred,
            'element_count_pred': element_count_pred, 'hp_pred': hp_pred,
            'sc_pred': sc_pred, 'family': family,
        }

    def forward(self, element_indices, element_fractions, element_mask,
                magpie, tc) -> Dict[str, torch.Tensor]:
        enc = self.encode(element_indices, element_fractions, element_mask,
                          magpie, tc)
        z = enc['z']
        dec = self.decode(z)
        heads = self._heads(z, dec)
        family = heads.pop('family')
        return {
            'z': z, 'z_mean': z, 'kl_loss': torch.mean(torch.square(z)),
            'attention_weights': enc['attention_weights'],
            'element_embeddings': enc['element_embeddings'],
            'attended_input': dec['attended_input'],
            'numden_pred': (self.numden_head(z) if self.cfg.use_numden_head
                            else None),
            **heads,
            'family_coarse_logits': family['coarse_logits'],
            'family_cuprate_sub_logits': family['cuprate_sub_logits'],
            'family_iron_sub_logits': family['iron_sub_logits'],
            'family_composed_14': family['composed_14'],
        }

    def heads_from_z(self, z) -> Dict[str, torch.Tensor]:
        """All encoder heads from z alone (no input features exist for a
        sampled latent), plus the decoder conditioning ``heads_vec`` and
        ``stoich``."""
        heads = self._heads(z, self.decode(z))
        out = {k: v for k, v in heads.items() if k != 'family'}
        out['family_composed_14'] = heads['family']['composed_14']
        out['heads_vec'] = self.heads_pred_for_decoder(out)
        out['stoich'] = torch.cat(
            [out['fraction_pred'], out['element_count_pred'][:, None]], dim=1)
        return out

    @staticmethod
    def heads_pred_for_decoder(out: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The 24-dim heads-conditioning vector of the decoder memory:
        [tc(1), sc(1), hp(1), tc_class(5), competence(1), count(1), family(14)]."""
        return torch.cat([
            out['tc_pred'][:, None], out['sc_pred'][:, None],
            out['hp_pred'][:, None], out['tc_class_logits'],
            out['competence'][:, None], out['element_count_pred'][:, None],
            out['family_composed_14'],
        ], dim=-1)


def predict_tc_mc(encoder: MaterialsEncoder, z: torch.Tensor, seed: int,
                  n_samples: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """MC-dropout Tc refinement and uncertainty from latent z: ``n_samples``
    passes of ``decode`` with dropout on give the mean prediction and the
    unbiased (ddof=1) std, each [B] in normalized Tc units.

    The passes run as one forward over ``n_samples`` stacked copies of z;
    the dropout masks come from torch's global stream seeded with ``seed``
    inside ``fork_rng``, so the caller's stream is left as it was (the
    train step's ``dropout_seed`` convention).  ``decode`` alone runs in
    train mode, without gradients, and the encoder gets its mode back."""
    b = z.shape[0]
    cuda = [z.device] if z.device.type == 'cuda' else []
    was_training = encoder.training
    try:
        with torch.random.fork_rng(devices=cuda), torch.no_grad():
            torch.manual_seed(seed)
            encoder.train()
            preds = encoder.decode(z.repeat(n_samples, 1))['tc_pred'].float()
    finally:
        encoder.train(was_training)
    preds = preds.reshape(n_samples, b)
    return preds.mean(dim=0), preds.std(dim=0, correction=1)
