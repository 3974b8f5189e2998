"""Reference PyTorch checkpoints -> the port's modules (port of
checkpoint/torch_convert.py).

The reference saves ``encoder_state_dict`` and ``decoder_state_dict``
(and, from V12.31, ``physics_z_loss_fn_state_dict``).  The port's
modules carry the flax module names, so each reference parameter maps
straight onto a port parameter name, with no transpose: a reference
``nn.Linear`` and a port ``Dense`` both hold ``weight`` as [out, in].  The
one reshaping is the decoder's fused ``nn.MultiheadAttention``
``in_proj_weight`` / ``in_proj_bias``, split into the q, k and v
``Dense``s of each layer.

Reference parameters without a counterpart (the unused
``property_encoder`` / ``combiner`` inside ``ElementEmbedding``, the
disabled ``skip_to_memory`` / ``numden_head``) are skipped, as the
reference's own ``strict=False`` loading of legacy weights skips them.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig

# (kind, reference prefix, port prefix); kinds: 'linear' (weight, bias if
# present), 'layernorm' (weight, bias), 'embed' (weight), 'param' (the
# prefix is the parameter itself)
_Map = List[Tuple[str, str, str]]


def _tensor(v) -> torch.Tensor:
    """A float32 CPU copy of a tensor or array."""
    if isinstance(v, torch.Tensor):
        return v.detach().to('cpu', torch.float32).clone()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _apply(sd: Mapping, mapping: _Map) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for kind, ref, port in mapping:
        if kind == 'param':
            out[port] = _tensor(sd[ref])
            continue
        out[f'{port}.weight'] = _tensor(sd[f'{ref}.weight'])
        if kind != 'embed' and (kind == 'layernorm' or f'{ref}.bias' in sd):
            out[f'{port}.bias'] = _tensor(sd[f'{ref}.bias'])
    return out


def encoder_name_map() -> _Map:
    """The reference ``FullMaterialsVAE`` names -> ``MaterialsEncoder``'s."""
    ea = 'element_encoder.element_attention'       # the same name in both
    m: _Map = [
        ('embed', 'element_encoder.element_embedding.element_embed',
         'element_encoder.element_embed'),
        ('param', f'{ea}.query', f'{ea}.query'),
        ('linear', f'{ea}.key_proj', f'{ea}.key_proj'),
        ('linear', f'{ea}.value_proj', f'{ea}.value_proj'),
        ('linear', f'{ea}.output_proj', f'{ea}.output_proj'),
        ('layernorm', f'{ea}.layer_norm', f'{ea}.LayerNorm_0'),
        ('linear', 'element_encoder.output_projection.0',
         'element_encoder.output_projection.Dense_0'),
        ('layernorm', 'element_encoder.output_projection.1',
         'element_encoder.output_projection.LayerNorm_0'),
    ]
    for i, (d, ln) in enumerate(((0, 1), (4, 5))):
        m += [('linear', f'magpie_encoder.{d}', f'magpie_encoder.Dense_{i}'),
              ('layernorm', f'magpie_encoder.{ln}', f'magpie_encoder.LayerNorm_{i}')]
    m += [('linear', 'tc_encoder.0', 'tc_encoder_pre.Dense_0'),
          ('linear', 'tc_encoder.2', 'tc_encoder_pre.Dense_1'),
          ('layernorm', 'tc_encoder.3', 'tc_encoder_ln'),
          ('linear', 'fusion.0', 'fusion.Dense_0'),
          ('layernorm', 'fusion.1', 'fusion.LayerNorm_0')]
    for i, (d, ln) in enumerate(((0, 1), (3, 4))):
        m += [('linear', f'vae_encoder.encoder.{d}', f'latent_mlp.Dense_{i}'),
              ('layernorm', f'vae_encoder.encoder.{ln}', f'latent_mlp.LayerNorm_{i}')]
    m.append(('linear', 'vae_encoder.fc_mean', 'fc_mean'))
    for i, (d, ln) in enumerate(((0, 1), (4, 5))):
        m += [('linear', f'decoder_backbone.{d}', f'decoder_backbone.Dense_{i}'),
              ('layernorm', f'decoder_backbone.{ln}', f'decoder_backbone.LayerNorm_{i}')]
    m += [('linear', 'tc_proj', 'tc_proj'),
          ('linear', 'tc_res_block.0', 'tc_res_block.Dense_0'),
          ('layernorm', 'tc_res_block.1', 'tc_res_block.LayerNorm_0'),
          ('linear', 'tc_res_block.4', 'tc_res_block.Dense_1'),
          ('layernorm', 'tc_out.0', 'tc_out_ln'),
          ('linear', 'tc_out.2', 'tc_out_1'),
          ('linear', 'tc_out.4', 'tc_out_2'),
          ('linear', 'magpie_head.0', 'magpie_head.Dense_0'),
          ('linear', 'magpie_head.2', 'magpie_head.Dense_1'),
          ('linear', 'attended_head.0', 'attended_head'),
          ('layernorm', 'attended_head.1', 'attended_head_ln'),
          ('linear', 'competence_head.0', 'competence_head.Dense_0'),
          ('linear', 'competence_head.2', 'competence_head.Dense_1'),
          ('linear', 'fraction_head.0', 'fraction_d0'),
          ('layernorm', 'fraction_head.1', 'fraction_ln'),
          ('linear', 'fraction_head.4', 'fraction_d1'),
          ('linear', 'fraction_head.6', 'fraction_d2'),
          ('linear', 'hp_head.0', 'hp_d0'),
          ('linear', 'hp_head.2', 'hp_d1'),
          ('linear', 'tc_class_head.0', 'tc_class_head.Dense_0'),
          ('linear', 'tc_class_head.3', 'tc_class_head.Dense_1'),
          ('linear', 'sc_head.0', 'sc_d0'),
          ('layernorm', 'sc_head.2', 'sc_ln'),
          ('linear', 'sc_head.4', 'sc_d1'),
          ('linear', 'sc_head.6', 'sc_d2')]
    fam = 'hierarchical_family_head'
    for head, fx in (('coarse_head', 'coarse'), ('cuprate_sub_head', 'cuprate_sub')):
        m += [('linear', f'{fam}.{head}.0', f'family_head.{fx}_d0'),
              ('layernorm', f'{fam}.{head}.1', f'family_head.{fx}_ln'),
              ('linear', f'{fam}.{head}.4', f'family_head.{fx}_d1'),
              ('linear', f'{fam}.{head}.6', f'family_head.{fx}_out')]
    m += [('linear', f'{fam}.iron_sub_head.0', 'family_head.iron_sub_d0'),
          ('layernorm', f'{fam}.iron_sub_head.1', 'family_head.iron_sub_ln'),
          ('linear', f'{fam}.iron_sub_head.4', 'family_head.iron_sub_out')]
    return m


def decoder_name_map(cfg: ModelConfig) -> _Map:
    """The reference ``EnhancedTransformerDecoder`` names ->
    ``FormulaDecoder``'s, but for the fused attention projections
    (``convert_decoder_state`` splits them)."""
    mb = 'memory_builder'
    m: _Map = [('embed', 'token_embedding', 'token_embedding')]
    if cfg.memory_bottleneck_dim > 0:
        m += [('linear', 'latent_to_memory.0', f'{mb}.latent_bottleneck'),
              ('layernorm', 'latent_to_memory.1', f'{mb}.LayerNorm_0'),
              ('linear', 'latent_to_memory.3', f'{mb}.latent_out')]
        stoich_ln, heads_ln = 'LayerNorm_1', 'LayerNorm_2'
    else:
        m += [('linear', 'latent_to_memory.0', f'{mb}.latent_mid'),
              ('linear', 'latent_to_memory.2', f'{mb}.latent_out')]
        stoich_ln, heads_ln = 'LayerNorm_0', 'LayerNorm_1'
    m += [('linear', 'stoich_to_memory.0', f'{mb}.stoich_mid'),
          ('layernorm', 'stoich_to_memory.1', f'{mb}.{stoich_ln}'),
          ('linear', 'stoich_to_memory.3', f'{mb}.stoich_out'),
          ('linear', 'heads_to_memory.0', f'{mb}.heads_mid1'),
          ('layernorm', 'heads_to_memory.1', f'{mb}.{heads_ln}'),
          ('linear', 'heads_to_memory.3', f'{mb}.heads_mid2'),
          ('linear', 'heads_to_memory.5', f'{mb}.heads_out')]
    for i in range(cfg.num_layers):
        tl, fl = f'transformer_decoder.layers.{i}', f'layer_{i}'
        m += [('linear', f'{tl}.self_attn.out_proj', f'{fl}.self_o'),
              ('linear', f'{tl}.multihead_attn.out_proj', f'{fl}.cross_o'),
              ('linear', f'{tl}.linear1', f'{fl}.ff1'),
              ('linear', f'{tl}.linear2', f'{fl}.ff2')]
        m += [('layernorm', f'{tl}.norm{n}', f'{fl}.norm{n}') for n in (1, 2, 3)]
    m += [('layernorm', 'output_proj.0', 'out_ln'),
          ('linear', 'output_proj.1', 'out_d1'),
          ('linear', 'output_proj.4', 'out_d2'),
          ('linear', 'stop_head.0', 'stop_d1'),
          ('linear', 'stop_head.2', 'stop_d2'),
          ('linear', 'site_dup_head.0', 'dup_d1'),
          ('linear', 'site_dup_head.2', 'dup_d2'),
          ('layernorm', 'token_type_head.0', 'type_ln'),
          ('linear', 'token_type_head.1', 'type_d1'),
          ('linear', 'token_type_head.4', 'type_d2'),
          ('linear', 'token_type_head.7', 'type_d3')]
    return m


def convert_encoder_state(sd: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A reference ``FullMaterialsVAE`` state dict -> a ``MaterialsEncoder``
    state dict (float32 CPU tensors)."""
    return _apply(sd, encoder_name_map())


def convert_decoder_state(sd: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A reference ``EnhancedTransformerDecoder`` state dict -> a
    ``FormulaDecoder`` state dict, each fused q/k/v projection split into
    three ``Dense``s."""
    out = _apply(sd, decoder_name_map(cfg))
    d = cfg.d_model
    for i in range(cfg.num_layers):
        tl = f'transformer_decoder.layers.{i}'
        for attn, prefix in (('self_attn', 'self'), ('multihead_attn', 'cross')):
            w = _tensor(sd[f'{tl}.{attn}.in_proj_weight'])
            b = _tensor(sd[f'{tl}.{attn}.in_proj_bias'])
            for j, name in enumerate('qkv'):
                out[f'layer_{i}.{prefix}_{name}.weight'] = w[j * d:(j + 1) * d].clone()
                out[f'layer_{i}.{prefix}_{name}.bias'] = b[j * d:(j + 1) * d].clone()
    return out


def model_config_from_torch(ckpt: Mapping) -> ModelConfig:
    """The architecture's widths read from a reference checkpoint's shapes
    (the reference's own detection, holdout_search_targeted.py:200)."""
    dec, enc = ckpt['decoder_state_dict'], ckpt['encoder_state_dict']
    shape = lambda sd, k: tuple(np.shape(sd[k]))  # noqa: E731
    vocab, d_model = shape(dec, 'token_embedding.weight')
    n_layers = 1 + max(int(re.match(r'transformer_decoder\.layers\.(\d+)\.', k).group(1))
                       for k in dec if k.startswith('transformer_decoder.layers.'))
    ffn = shape(dec, 'transformer_decoder.layers.0.linear1.weight')[0]
    latent = shape(enc, 'vae_encoder.fc_mean.weight')[0]
    fusion = shape(enc, 'tc_encoder.2.weight')[0]
    magpie = shape(enc, 'magpie_head.2.weight')[0]
    elem_embed = shape(enc, 'element_encoder.element_embedding.element_embed.weight')[1]
    bottleneck = (shape(dec, 'latent_to_memory.0.weight')[0]
                  if 'latent_to_memory.3.weight' in dec else 0)
    return ModelConfig(
        latent_dim=latent, fusion_dim=fusion, magpie_dim=magpie,
        encoder_hidden=(fusion * 2, fusion), decoder_hidden=(fusion, fusion * 2),
        element_embed_dim=elem_embed, vocab_size=vocab, d_model=d_model,
        num_layers=n_layers, dim_feedforward=ffn, memory_bottleneck_dim=bottleneck)


def convert_physics_z_state(ckpt: Mapping) -> Dict[str, torch.Tensor]:
    """The learnable Magpie projection from the reference's saved loss
    module (``physics_z_loss_fn_state_dict``, ``magpie_loss.projection.*``)
    as an ``nn.Linear`` state dict; {} when the checkpoint predates
    V12.31."""
    sd = ckpt.get('physics_z_loss_fn_state_dict') or {}
    if 'magpie_loss.projection.weight' not in sd:
        return {}
    return {'weight': _tensor(sd['magpie_loss.projection.weight']),
            'bias': _tensor(sd['magpie_loss.projection.bias'])}


def load_torch_checkpoint(path: str) -> Tuple[Dict, Dict, ModelConfig, Dict]:
    """A reference ``.pt`` file -> (encoder state dict, decoder state dict,
    model config, metadata).  The metadata holds the checkpoint's scalar
    entries and, when it carries the physics-Z loss module's state,
    ``pz_params`` (the projection's state dict)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    cfg = model_config_from_torch(ckpt)
    enc = convert_encoder_state(ckpt['encoder_state_dict'], cfg)
    dec = convert_decoder_state(ckpt['decoder_state_dict'], cfg)
    meta = {k: v for k, v in ckpt.items()
            if not k.endswith('state_dict') and np.isscalar(v)}
    pz = convert_physics_z_state(ckpt)
    if pz:
        meta['pz_params'] = pz
    return enc, dec, cfg, meta

