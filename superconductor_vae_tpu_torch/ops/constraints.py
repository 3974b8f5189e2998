"""Differentiable constraint losses of the SC constraint zoo (port of
ops/constraints.py): A3 site occupancy and A6 charge balance, over the
encoder's composition arrays.

``ConstraintConfig`` is here because ``RLConfig`` carries it; the reward
modifiers that read it (``constraint_rewards``) come with the RL slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..chem.elements import primary_oxidation_state_table


@dataclasses.dataclass(frozen=True)
class ConstraintConfig:
    """Penalties of the constraint rewards (A1/A4/A7, B1-B8)."""
    a1_duplicate_penalty: float = -50.0
    a4_stoich_norm_penalty: float = -10.0
    a7_impossible_element_penalty: float = -30.0
    family_enabled: bool = True
    family_confidence: float = 0.8
    b1_ybco_oxygen: float = -40.0
    b2_lsco_sr_doping: float = -40.0
    b3_bscco_ca_cu: float = -40.0
    b4_hg_volatile: float = -30.0
    b5_tl_poison: float = -30.0
    b6_iron_oxygen: float = -30.0
    b7_mgb2_poison: float = -30.0
    b8_a15_ratio: float = -30.0


# A3 site definitions: (family id, elements sharing the site, target sum)
_SITE_DEFS = [
    (2, {39, 63, 60, 62, 64, 66, 67, 68, 69, 70, 71, 59, 57}, 1.0),
    (2, {56, 38, 20}, 2.0),
    (3, {57, 38, 20, 56}, 2.0),
    (4, {83, 82}, 2.0),
    (5, {81, 82}, 2.0),
    (6, {80, 81}, 1.0),
    (8, {57, 60, 62, 58, 20, 56}, 1.0),
    (10, {12, 3, 11, 13, 20}, 1.0),
]


def _site_tables():
    membership = np.zeros((len(_SITE_DEFS), 119), np.float32)
    fam_ids = np.zeros(len(_SITE_DEFS), np.int64)
    targets = np.zeros(len(_SITE_DEFS), np.float32)
    for i, (fam, zs, tgt) in enumerate(_SITE_DEFS):
        membership[i, sorted(zs)] = 1.0
        fam_ids[i] = fam
        targets[i] = tgt
    return membership, fam_ids, targets


@functools.cache
def _device_tables(device: torch.device):
    """(site membership [S, 119], site family [S], site target [S],
    oxidation state [119]) on ``device``, made once: a copy from the host
    would wait for the device on every call."""
    membership, fam_ids, targets = _site_tables()
    return tuple(torch.as_tensor(t, device=device) for t in (
        membership, fam_ids, targets, primary_oxidation_state_table()))


def site_occupancy_loss(
    element_indices: torch.Tensor,    # [B, E] atomic numbers
    element_fractions: torch.Tensor,  # [B, E] (differentiable)
    element_mask: torch.Tensor,       # [B, E]
    family_predictions: Optional[torch.Tensor],  # [B, 14] probs
    confidence_threshold: float = 0.8,
) -> torch.Tensor:
    """A3: mean L1 deviation of the site-sharing element sums from their
    targets, over the (row, rule) pairs whose family is predicted with
    confidence >= ``confidence_threshold`` and that hold a site element.
    A soft shaping term: fractions are molar, targets formula-unit sums."""
    dev = element_fractions.device
    if family_predictions is None:
        return torch.zeros((), device=dev)
    membership, site_fam, site_target, _ = _device_tables(dev)   # [S, 119], [S], [S]
    conf, fam = family_predictions.max(dim=1)
    onehot = (torch.arange(119, device=dev)[None, None, :]
              == element_indices[..., None]).to(element_fractions.dtype)
    frac = element_fractions * element_mask.to(element_fractions.dtype)
    per_z = torch.einsum('be,bez->bz', frac, onehot)                # [B, 119]
    site_sums = per_z @ membership.T                                # [B, S]
    has_site_elem = ((per_z > 0).to(membership.dtype) @ membership.T) > 0
    applies = ((fam[:, None] == site_fam[None, :])
               & (conf[:, None] >= confidence_threshold) & has_site_elem)
    deviation = (site_sums - site_target[None, :]).abs()
    n = applies.sum().clamp_min(1)
    return (deviation * applies).sum() / n


def charge_balance_loss(
    element_indices: torch.Tensor,
    element_fractions: torch.Tensor,
    element_mask: torch.Tensor,
    tolerance: float = 0.5,
) -> torch.Tensor:
    """A6: tanh penalty on |sum(frac * oxidation_state)| above tolerance."""
    ox = _device_tables(element_fractions.device)[3][element_indices.clamp(0, 118)]
    charge = (element_fractions * ox
              * element_mask.to(element_fractions.dtype)).sum(dim=1)
    excess = (charge.abs() - tolerance).clamp_min(0.0)
    return torch.tanh(excess).mean()
