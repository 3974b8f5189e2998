"""A5 round-trip cycle consistency (port of ops/round_trip.py).

Decode the first ``subset`` latents of the batch greedily, turn each token
stream into the encoder's composition slots on the device (element amounts
from ops/token_stats.py, then the 12 largest), re-encode them with the
predicted Magpie and Tc as the other inputs, and penalise ``||z - z'||``
and the re-decoded Tc's error.  The whole round trip stays on the device
and makes the host wait nowhere: the rollout is a fixed 29-step greedy
decode without gates or early exit.

The rollout runs under ``no_grad`` (``generate_with_kv_cache``), through
K1 under ``cfg.pallas_decode``.  Its outputs are integer tokens, so no
gradient reaches the decoder in either package; the gradient flows into
the encoder through the re-encoding and through ``z``, ``magpie_pred``
and ``tc_pred``, none of which is detached.  (The JAX function traces its
rollout under ``value_and_grad``; with its Pallas decode kernel that
raises, so JAX runs it with ``pallas_decode=False``, which computes the
same tokens.)  The re-encoding and the re-decoding run without dropout,
as JAX's ``encode`` and ``decode`` default to ``deterministic``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..generation.generate import GenerationConfig, generate_with_kv_cache
from .token_stats import element_amounts


def tokens_to_composition(tokens: torch.Tensor, mask: torch.Tensor,
                          token_to_z: torch.Tensor,
                          token_value_table: torch.Tensor,
                          max_elements: int = 12):
    """Token stream -> (element_indices [B, max_elements] int64, fractions,
    mask) slot arrays: the ``max_elements`` largest element amounts, the
    lower atomic number first among equal amounts (``jax.lax.top_k``'s
    rule; every zero amount ties, and so do a formula's equal amounts), as
    a stable descending sort gives it."""
    amounts = element_amounts(tokens, mask, token_to_z, token_value_table)
    amounts = torch.cat([torch.zeros_like(amounts[:, :1]), amounts[:, 1:]], dim=1)
    top_amt, top_z = torch.sort(amounts, dim=1, descending=True, stable=True)
    top_amt, top_z = top_amt[:, :max_elements], top_z[:, :max_elements]
    slot_mask = top_amt > 0
    total = (top_amt * slot_mask).sum(dim=1, keepdim=True).clamp_min(1e-6)
    fractions = (top_amt / total).masked_fill(~slot_mask, 0.0)
    return top_z, fractions, slot_mask


def round_trip_loss(
    encoder, decoder,
    z: torch.Tensor, stoich: torch.Tensor, heads_vec: torch.Tensor,
    magpie_pred: torch.Tensor, tc_pred: torch.Tensor,
    luts: Dict[str, torch.Tensor],
    subset: int,
    z_weight: float = 1.0,
    tc_weight: float = 5.0,
    max_len: int = 30,
) -> Dict[str, torch.Tensor]:
    """Returns {'round_trip_loss', 'z_mse', 'tc_mse'} over the first
    ``subset`` rows (a fixed subset size, the reference's
    ``subset_fraction``), and the rollout's ``tokens``."""
    zs = z[:subset]
    gcfg = GenerationConfig(max_len=max_len, temperature=0.0)
    gen = generate_with_kv_cache(decoder, zs.detach(), stoich[:subset].detach(),
                                 heads_vec[:subset].detach(), None, gcfg)
    e_idx, e_frac, e_mask = tokens_to_composition(
        gen['tokens'], gen['mask'], luts['token_to_z'], luts['token_value_table'],
        max_elements=encoder.cfg.max_elements)

    was_training = encoder.training
    encoder.eval()
    try:
        z2 = encoder.encode(e_idx, e_frac, e_mask, magpie_pred[:subset],
                            tc_pred[:subset])['z']
        tc2 = encoder.decode(z2)['tc_pred']
    finally:
        encoder.train(was_training)

    z_mse = ((z2 - zs) ** 2).mean()
    tc_mse = ((tc2 - tc_pred[:subset]) ** 2).mean()
    return {
        'round_trip_loss': z_weight * z_mse + tc_weight * tc_mse,
        'z_mse': z_mse, 'tc_mse': tc_mse, 'tokens': gen['tokens'],
    }
