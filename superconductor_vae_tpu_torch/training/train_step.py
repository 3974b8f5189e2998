"""Pieces of training/train_step.py that the inference path needs:
the decoder's stoichiometry conditioning and the tokenizer LUTs on the
device.  The train step itself comes with the training slice."""

from __future__ import annotations

from typing import Dict

import torch

from ..tokenizer import FractionAwareTokenizer
from ..utils.device import resolve_device


def build_luts(tokenizer: FractionAwareTokenizer,
               device='cuda') -> Dict[str, torch.Tensor]:
    """The tokenizer's dense LUTs as tensors on ``device``."""
    device = resolve_device(device)
    return {
        'fraction_values': torch.as_tensor(tokenizer.fraction_value_table, device=device),
        'token_value_table': torch.as_tensor(tokenizer.token_value_table, device=device),
        'token_to_z': torch.as_tensor(tokenizer.token_to_element_z, device=device),
        'type_masks': torch.as_tensor(tokenizer.type_masks, device=device),
        'type_table': torch.as_tensor(tokenizer.token_type_table, device=device),
    }


def stoich_conditioning(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B, 13] = ground-truth fractions (12) + element count (1)."""
    em = batch['element_mask'].float()
    count = em.sum(dim=1, keepdim=True)
    return torch.cat([batch['element_fractions'] * em, count], dim=1)
