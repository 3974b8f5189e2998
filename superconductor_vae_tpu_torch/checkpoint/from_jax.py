"""Flax parameter trees -> the port's modules (the inverse of the map in
checkpoint/torch_convert.py of the JAX package).

The port's submodules carry the flax module names, so a flax leaf path
``a/b/kernel`` is the torch parameter ``a.b.weight``.  Leaves:

    kernel     [in, out]  -> weight [out, in]   (Dense -> Linear)
    bias                  -> bias
    scale                 -> weight             (LayerNorm)
    embedding             -> weight             (Embed -> Embedding)
    query                 -> query              (ElementAttention)
    slot_queries          -> slot_queries       (SetFormulaDecoder)

The trees come in as numpy arrays (``jax.tree.map(np.asarray, params)``),
so this module needs no JAX.  Loading is strict: a missing, unexpected or
mis-shaped parameter raises.  The physics-Z Magpie projection
(``{'kernel': [M, 62], 'bias': [62]}``) becomes an ``nn.Linear``; the
train state's ``set_params`` a ``SetFormulaDecoder`` whose widths are read
from the tree's shapes.

The legacy modules (models/feature_groups.py, models/legacy.py) load the
same way (``grouped_feature_encoder_from_jax`` and the functions after
it); flax's attention keeps its q/k/v kernels as [in, H, Dh] and its
output kernel as [H, Dh, out], which are flattened to ``Linear`` weights.

A machine without the Orbax reader (tensorstore) takes the trees from an
npz file instead (``load_params_npz``): one float32 array a leaf, keyed by
its ``/``-joined path under ``enc_params/``, ``dec_params/`` and, where the
train state has a set decoder, ``set_params/``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.config import ModelConfig
from ..models.decoder import FormulaDecoder
from ..models.encoder import MaterialsEncoder
from ..models.set_decoder import SetFormulaDecoder

_LEAF = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight',
         'embedding': 'weight', 'query': 'query', 'slot_queries': 'slot_queries'}
GROUPS = ('enc_params', 'dec_params', 'set_params')


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_params_npz(path: str | Path) -> Dict[str, Dict]:
    """{group: nested dict of numpy arrays} from an npz file whose keys are
    ``<group>/<path>``: ``enc_params`` and ``dec_params``, and
    ``set_params`` where the file holds it."""
    trees: Dict[str, Dict] = {}
    with np.load(path) as npz:
        for key in npz.files:
            root, *mods, leaf = key.split('/')
            if root not in GROUPS or not mods:
                raise KeyError(f'{path}: unexpected key {key}')
            node = trees.setdefault(root, {})
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = npz[key]
    for root in GROUPS[:2]:
        if root not in trees:
            raise KeyError(f'{path}: no {root}')
    return trees


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax param tree (with or without the ``params`` collection key)
    as a torch state dict of float32 CPU tensors."""
    if set(params) == {'params'}:
        params = params['params']
    sd = {}
    for path, leaf in _flatten(params):
        *mods, name = path
        if name not in _LEAF:
            raise KeyError(f'unknown flax leaf {"/".join(path)}')
        arr = np.array(leaf, dtype=np.float32)   # a copy; bf16 snapshots widen here
        if name == 'kernel':
            arr = np.ascontiguousarray(arr.T)
        sd['.'.join([*mods, _LEAF[name]])] = torch.from_numpy(arr)
    return sd


def set_decoder_from_jax(set_params: Mapping, device='cuda',
                         dtype=torch.float32) -> SetFormulaDecoder:
    """The train state's ``set_params`` loaded into a new
    ``SetFormulaDecoder`` on ``device`` (in eval mode) computing in
    ``dtype``.  Its widths come from the tree's shapes; the head count,
    which they do not show, is the module's default, 8, the only one the
    JAX train step builds."""
    sd = state_dict_from_flax(set_params)
    n_slots, d_model = sd['slot_queries'].shape
    n_layers = len({k.split('.')[0] for k in sd if k.startswith('layer_')})
    dec = SetFormulaDecoder(
        latent_dim=sd['z_proj.weight'].shape[1], d_model=d_model, num_layers=n_layers,
        dim_feedforward=sd['layer_0.Dense_0.weight'].shape[0], n_slots=n_slots,
        n_elements=sd['element_head.weight'].shape[0] - 1,
        n_z_tokens=sd['z_proj.weight'].shape[0] // d_model, device=device, dtype=dtype)
    dec.load_state_dict(sd, strict=True)
    return dec.eval()


def params_from_jax(enc_params: Mapping, dec_params: Mapping, cfg: ModelConfig,
                    device='cuda', dtype=torch.float32,
                    pz_params: Optional[Mapping] = None,
                    set_params: Optional[Mapping] = None) -> Tuple:
    """The JAX package's encoder and decoder params, as numpy trees, loaded
    into a new ``MaterialsEncoder`` and ``FormulaDecoder`` on ``device``
    (in eval mode) that compute in ``dtype`` (flax's ``dtype``); the
    parameters are float32 whatever it is.  Returns (encoder, decoder),
    then, given the train state's ``pz_params``, the projection as a
    float32 ``nn.Linear(M, 62)``, then, given its ``set_params``, the set
    decoder (``set_decoder_from_jax``)."""
    encoder = MaterialsEncoder(cfg, device=device, dtype=dtype)
    decoder = FormulaDecoder(cfg, device=device, dtype=dtype)
    encoder.load_state_dict(state_dict_from_flax(enc_params), strict=True)
    decoder.load_state_dict(state_dict_from_flax(dec_params), strict=True)
    out = (encoder.eval(), decoder.eval())
    if pz_params is not None:
        m, n_out = np.shape(pz_params['kernel'])
        proj = nn.Linear(m, n_out, device=device, dtype=torch.float32)
        proj.load_state_dict(state_dict_from_flax(pz_params), strict=True)
        out += (proj,)
    if set_params is not None:
        out += (set_decoder_from_jax(set_params, device, dtype),)
    return out


# ---- the legacy modules ------------------------------------------------------------

def _flatten_attention(att: Mapping) -> Dict:
    """flax MultiHeadDotProductAttention params with the DenseGeneral
    leaves flattened to Dense ones: q/k/v kernel [in, H, Dh] -> [in, H*Dh],
    bias [H, Dh] -> [H*Dh]; out kernel [H, Dh, out] -> [H*Dh, out]."""
    out = {}
    for name in ('query', 'key', 'value'):
        k = np.asarray(att[name]['kernel'])
        out[name] = {'kernel': k.reshape(k.shape[0], -1),
                     'bias': np.asarray(att[name]['bias']).reshape(-1)}
    k = np.asarray(att['out']['kernel'])
    out['out'] = {'kernel': k.reshape(-1, k.shape[-1]), 'bias': np.asarray(att['out']['bias'])}
    return out


def _load(module: nn.Module, params: Mapping, absent_prefixes: Tuple[str, ...] = ()):
    """Loads a flax tree into ``module``; strict, except that parameters
    under ``absent_prefixes`` may be missing from the tree (they keep
    their initial values).  Returns the module in eval mode."""
    sd = state_dict_from_flax(params)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    stray = [k for k in missing if not k.startswith(absent_prefixes)]
    if stray or unexpected:
        raise KeyError(f'{type(module).__name__}: missing {stray}, unexpected {unexpected}')
    return module.eval()


def grouped_feature_encoder_from_jax(params: Mapping, group_dims: Mapping[str, int],
                                     hidden_dim: int = 128, n_heads: int = 4,
                                     dropout: float = 0.1, device='cuda'):
    """A flax ``GroupedFeatureEncoder``'s params as the port's module.  A
    group that the flax module never saw has no params in its tree: the
    port's module keeps that group's initial ``Linear`` and
    ``LayerNorm``."""
    from ..models.feature_groups import GroupedFeatureEncoder
    if set(params) == {'params'}:
        params = params['params']
    tree = dict(params)
    tree['cross_attention'] = _flatten_attention(params['cross_attention'])
    absent = tuple(f'{p}_{g}.' for g in group_dims if f'enc_{g}' not in tree
                   for p in ('enc', 'ln'))
    return _load(GroupedFeatureEncoder(group_dims, hidden_dim, n_heads, dropout,
                                       device=device), tree, absent)


def expert_attention_head_from_jax(params: Mapping, hidden_dim: int,
                                   temperature: float = 1.0, device='cuda'):
    from ..models.feature_groups import ExpertAttentionHead
    p = params.get('params', params)
    return _load(ExpertAttentionHead(hidden_dim, temperature,
                                     in_dim=np.shape(p['key_proj']['kernel'])[0],
                                     device=device), p)


def attentive_expert_from_jax(params: Mapping, hidden_dim: int, output_dim: int = 1,
                              temperature: float = 1.0, device='cuda'):
    from ..models.feature_groups import AttentiveExpert
    p = params.get('params', params)
    return _load(AttentiveExpert(hidden_dim, output_dim, temperature,
                                 in_dim=np.shape(p['fc1']['kernel'])[0], device=device), p)


def contrastive_feature_encoder_from_jax(params: Mapping, input_dim: int,
                                         latent_dim: int = 64, hidden_dims=(256, 128),
                                         temperature: float = 0.07, dropout: float = 0.1,
                                         device='cuda'):
    """The encoder and the projection head (flax makes the latter only
    when its init runs ``encode_project``)."""
    from ..models.feature_groups import ContrastiveFeatureEncoder
    return _load(ContrastiveFeatureEncoder(input_dim, latent_dim, hidden_dims, temperature,
                                           dropout, device=device), params)


def bidirectional_vae_from_jax(params: Mapping, feature_dim: int = 145,
                               hidden_dims=(256, 128), latent_dim: int = 64,
                               dropout: float = 0.1, device='cuda'):
    from ..models.legacy import BidirectionalVAE
    return _load(BidirectionalVAE(feature_dim, tuple(hidden_dims), latent_dim, dropout,
                                  device=device), params)


def pointer_generator_from_jax(params: Mapping, vocab_size: int, d_model: int = 128,
                               nhead: int = 4, max_src: int = 12, device='cuda'):
    from ..models.legacy import PointerGeneratorDecoder
    return _load(PointerGeneratorDecoder(vocab_size, d_model, nhead, max_src,
                                         device=device), params)
