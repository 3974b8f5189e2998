"""Vocab surgery on the decoder's parameters (port of the vocab part of
models/surgery.py: ``expand_vocab_rows``, ``expand_output_head_rows``,
``isotope_parent_map``, ``expand_decoder_vocab``).

The row functions act on numpy arrays in the JAX package's layouts (an
embedding [V, d], a Dense kernel [d, V]) and draw from the same numpy
generators, so they give the same arrays; ``expand_decoder_vocab`` applies
them to the port's decoder ``state_dict`` (a ``Linear`` weight is the
transposed kernel).  The width and depth surgery stays in the phase-2
slice (A.14).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def expand_vocab_rows(
    embedding: np.ndarray,             # [V_old, d]
    new_vocab: int,
    parent_map: Optional[Dict[int, int]] = None,
    rng: Optional[np.random.Generator] = None,
    init_scale: float = 0.02,
) -> np.ndarray:
    """Grow the token embedding to ``new_vocab`` rows.  ``parent_map[new_id]
    = old_id`` starts a new row from a semantic parent (an isotope from its
    element) plus noise; other new rows get small random values."""
    emb = np.asarray(embedding)
    v_old, d = emb.shape
    rng = rng or np.random.default_rng(0)
    out = np.concatenate(
        [emb, init_scale * rng.standard_normal(
            (new_vocab - v_old, d)).astype(emb.dtype)], axis=0)
    if parent_map:
        for new_id, old_id in parent_map.items():
            if v_old <= new_id < new_vocab and old_id < v_old:
                out[new_id] = emb[old_id] + init_scale * \
                    rng.standard_normal(d).astype(emb.dtype)
    return out


def expand_output_head_rows(
    kernel: np.ndarray,                # [d, V_old]
    bias: np.ndarray,                  # [V_old]
    new_vocab: int,
    parent_map: Optional[Dict[int, int]] = None,
    new_bias_value: float = -4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Grow a vocab projection; new logits start suppressed (bias -4) or
    copy their parent's column."""
    k, b = np.asarray(kernel), np.asarray(bias)
    d, v_old = k.shape
    k_new = np.concatenate(
        [k, np.zeros((d, new_vocab - v_old), k.dtype)], axis=1)
    b_new = np.concatenate(
        [b, np.full(new_vocab - v_old, new_bias_value, b.dtype)])
    if parent_map:
        for new_id, old_id in parent_map.items():
            if v_old <= new_id < new_vocab and old_id < v_old:
                k_new[:, new_id] = k[:, old_id]
                b_new[new_id] = b[old_id]
    return k_new, b_new


def isotope_parent_map(tokenizer) -> Dict[int, int]:
    """ISO token id -> parent element token id (for vocab migration init)."""
    out = {}
    if not tokenizer.isotopes:
        return out
    from ..chem.isotopes import parse_isotope
    for i, iso in enumerate(tokenizer.isotopes):
        _, sym = parse_isotope(iso)
        out[tokenizer.isotope_token_start + i] = tokenizer.token_id(sym)
    return out


def expand_decoder_vocab(dec_state: Mapping[str, torch.Tensor], new_vocab: int,
                         parent_map: Optional[Dict[int, int]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Vocab migration of a ``FormulaDecoder`` state dict: grows the
    ``token_embedding`` rows and the output projection ``out_d2``.
    Returns a new state dict of CPU tensors."""
    sd = {k: v.detach().cpu() for k, v in dec_state.items()}
    emb = expand_vocab_rows(sd['token_embedding.weight'].numpy(), new_vocab, parent_map)
    k, b = expand_output_head_rows(sd['out_d2.weight'].numpy().T, sd['out_d2.bias'].numpy(),
                                   new_vocab, parent_map)
    sd['token_embedding.weight'] = torch.from_numpy(emb)
    sd['out_d2.weight'] = torch.from_numpy(np.ascontiguousarray(k.T))
    sd['out_d2.bias'] = torch.from_numpy(b)
    return sd
