"""True-autoregressive evaluation of one batch (port of training/evaluate.py).

``eval_batch`` is the body of the JAX package's jitted ``eval_batch``:
encoder, decoder memory, greedy KV-cache generation with the checkpoint's
decode gates and early exit, then the teacher-forced forward for TF-exact.
The loop over a dataset comes with the data slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..generation import GenerationConfig, generate_with_kv_cache
from ..tokenizer import EOS_ID
from .train_step import stoich_conditioning


def _exact_match(generated: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Per-sample: generated token stream equals target up to/incl. EOS; a
    target with no EOS is never exact."""
    b, t = targets.shape
    g = generated[:, :t]
    if g.shape[1] < t:
        g = np.pad(g, ((0, 0), (0, t - g.shape[1])), constant_values=-1)
    has_eos = (targets == EOS_ID).any(axis=1)
    eos_pos = np.where(has_eos, (targets == EOS_ID).argmax(axis=1), t - 1)
    needed = np.arange(t)[None, :] <= eos_pos[:, None]
    return ((g == targets) | ~needed).all(axis=1) & has_eos


def eval_generation_config(max_len: int, eval_gating: Mapping) -> GenerationConfig:
    """Greedy early-exit generation with a checkpoint's ``eval_gating``
    (``meta.json``: stop_boost, hard_stop_threshold, site_dup_threshold,
    use_type_masking_ar)."""
    return GenerationConfig(
        max_len=max_len, temperature=0.0,
        stop_boost=eval_gating.get('stop_boost', 0.0),
        hard_stop_threshold=eval_gating.get('hard_stop_threshold', 0.0),
        site_dup_threshold=eval_gating.get('site_dup_threshold', 0.0),
        use_type_masking=eval_gating.get('use_type_masking_ar', False),
        early_exit=True)


@torch.inference_mode()
def eval_batch(encoder, decoder, batch: Dict[str, torch.Tensor],
               gcfg: GenerationConfig,
               type_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One eval batch: returns the generated tokens [B, max_len-1], the
    TF argmax ``tf_pred`` [B, max_len-1], ``tc_pred``, ``sc_pred``,
    ``z_norm``, ``family_composed_14`` and the generation's ``margin``.

    ``batch`` holds element_indices / element_fractions / element_mask
    [B, 12], magpie [B, magpie_dim], tc [B] and tokens [B, max_len]."""
    enc_out = encoder(batch['element_indices'], batch['element_fractions'],
                      batch['element_mask'], batch['magpie'], batch['tc'])
    heads_vec = encoder.heads_pred_for_decoder(enc_out)
    stoich = stoich_conditioning(batch)
    gen = generate_with_kv_cache(decoder, enc_out['z'], stoich, heads_vec,
                                 None, gcfg, type_masks=type_masks)
    dec_out = decoder(enc_out['z'], batch['tokens'], stoich, heads_vec)
    return {
        'generated': gen['tokens'],
        'tf_pred': dec_out['generated'],
        'tc_pred': enc_out['tc_pred'],
        'sc_pred': enc_out['sc_pred'],
        'z_norm': torch.linalg.norm(enc_out['z'], dim=1),
        'family_composed_14': enc_out['family_composed_14'],
        'margin': gen['margin'],
    }
