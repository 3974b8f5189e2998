"""Flax parameter trees -> the port's modules (the inverse of the map in
checkpoint/torch_convert.py of the JAX package).

The port's submodules carry the flax module names, so a flax leaf path
``a/b/kernel`` is the torch parameter ``a.b.weight``.  Leaves:

    kernel     [in, out]  -> weight [out, in]   (Dense -> Linear)
    bias                  -> bias
    scale                 -> weight             (LayerNorm)
    embedding             -> weight             (Embed -> Embedding)
    query                 -> query              (ElementAttention)

The trees come in as numpy arrays (``jax.tree.map(np.asarray, params)``),
so this module needs no JAX.  Loading is strict: a missing, unexpected or
mis-shaped parameter raises.  The physics-Z Magpie projection
(``{'kernel': [M, 62], 'bias': [62]}``) becomes an ``nn.Linear``.

A machine without the Orbax reader (tensorstore) takes the trees from an
npz file instead (``load_params_npz``): one float32 array a leaf, keyed by
its ``/``-joined path under ``enc_params/`` and ``dec_params/``.
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

_LEAF = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight',
         'embedding': 'weight', 'query': 'query'}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_params_npz(path: str | Path) -> Tuple[Dict, Dict]:
    """(enc_params, dec_params) as nested dicts of numpy arrays from an npz
    file whose keys are ``enc_params/<path>`` and ``dec_params/<path>``."""
    trees: Dict[str, Dict] = {'enc_params': {}, 'dec_params': {}}
    with np.load(path) as npz:
        for key in npz.files:
            root, *mods, leaf = key.split('/')
            if root not in trees or not mods:
                raise KeyError(f'{path}: unexpected key {key}')
            node = trees[root]
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = npz[key]
    return trees['enc_params'], trees['dec_params']


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


def params_from_jax(enc_params: Mapping, dec_params: Mapping, cfg: ModelConfig,
                    device='cuda', dtype=torch.float32,
                    pz_params: Optional[Mapping] = None):
    """The JAX package's encoder and decoder params, as numpy trees, loaded
    into a new ``MaterialsEncoder`` and ``FormulaDecoder`` on ``device``
    (in eval mode) that compute in ``dtype`` (flax's ``dtype``); the
    parameters are float32 whatever it is.  Given the train state's
    ``pz_params`` too, returns (encoder, decoder, projection) with the
    projection as a float32 ``nn.Linear(M, 62)``."""
    encoder = MaterialsEncoder(cfg, device=device, dtype=dtype)
    decoder = FormulaDecoder(cfg, device=device, dtype=dtype)
    encoder.load_state_dict(state_dict_from_flax(enc_params), strict=True)
    decoder.load_state_dict(state_dict_from_flax(dec_params), strict=True)
    if pz_params is None:
        return encoder.eval(), decoder.eval()
    m, out = np.shape(pz_params['kernel'])
    proj = nn.Linear(m, out, device=device, dtype=torch.float32)
    proj.load_state_dict(state_dict_from_flax(pz_params), strict=True)
    return encoder.eval(), decoder.eval(), proj
