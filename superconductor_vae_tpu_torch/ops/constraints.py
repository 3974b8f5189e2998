"""The SC constraint zoo (port of ops/constraints.py): the reward
modifiers of the RL step (A1 duplicates, A4 reducible stoichiometry, A7
impossible combinations, and the family-gated rules B1-B8) over token
streams, and the differentiable losses A3 (site occupancy) and A6 (charge
balance) over the encoder's composition arrays.  Every rule is a
whole-batch contraction over ``[B, 119]`` element accumulators.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..chem.elements import primary_oxidation_state_table
from .token_stats import (
    element_amounts, element_counts, integer_subscripts, stream_has_fraction,
)


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


_MAGNETIC_3D = (25, 26, 27, 28)  # Mn Fe Co Ni


def constraint_rewards(
    sampled: torch.Tensor,            # [B, T] token ids
    mask: torch.Tensor,               # [B, T]
    token_to_z: torch.Tensor,         # [V] tokenizer LUT
    token_value_table: torch.Tensor,  # [V] tokenizer LUT
    cfg: ConstraintConfig = ConstraintConfig(),
    family_predictions: Optional[torch.Tensor] = None,  # [B, 14] probs
) -> torch.Tensor:
    """[B] total constraint reward (non-positive)."""
    mask = mask.float()
    amounts = element_amounts(sampled, mask, token_to_z, token_value_table)
    counts = element_counts(sampled, mask, token_to_z)
    present = amounts > 0

    # A1: duplicate element occurrences
    pen = (counts > 1.0).any(dim=1) * cfg.a1_duplicate_penalty

    # A4: reducible integer stoichiometry (a common divisor of all
    # subscripts > 1), only for fraction-free formulas with >= 2 subscripts;
    # subscripts are <= 20, so a shared divisor in 2..20 is that
    vals, elem_pos = integer_subscripts(sampled, mask)
    n_subs = elem_pos.sum(dim=1)
    divisors = torch.arange(2, 21, dtype=torch.float32, device=sampled.device)
    divisible = torch.remainder(vals[..., None], divisors) == 0        # [B,T,19]
    all_div = (divisible | ~elem_pos[..., None]).all(dim=1)
    gcd_gt1 = all_div.any(dim=1) & (n_subs >= 2)
    no_frac = ~stream_has_fraction(sampled, mask)
    pen = pen + (gcd_gt1 & no_frac) * cfg.a4_stoich_norm_penalty

    # A7: impossible combinations: the pair (F, Tl); a magnetic 3d metal
    # beside Cu at a comparable amount
    forbidden = present[:, 9] & present[:, 81]
    cu_amt = amounts[:, 29]
    mag_violation = torch.zeros_like(forbidden)
    for z in _MAGNETIC_3D:
        mag_amt = amounts[:, z]
        mag_violation = mag_violation | (
            (cu_amt > 0) & (mag_amt > 0.02) & (mag_amt > 0.5 * cu_amt))
    pen = pen + (forbidden | mag_violation) * cfg.a7_impossible_element_penalty

    # B1-B8: physics rules gated on a confident family prediction
    if cfg.family_enabled and family_predictions is not None:
        conf, fam = family_predictions.max(dim=1)
        gate = conf >= cfg.family_confidence
        o, sr, ca, cu = amounts[:, 8], amounts[:, 38], amounts[:, 20], amounts[:, 29]
        v_amt, li, c_amt, al = amounts[:, 23], amounts[:, 3], amounts[:, 6], amounts[:, 13]
        mag10 = torch.zeros_like(gate)
        mag05 = torch.zeros_like(gate)
        for z in _MAGNETIC_3D:
            mag10 = mag10 | (amounts[:, z] > 0.10)
            mag05 = mag05 | (amounts[:, z] > 0.05)
        a_tot = amounts[:, 41] + amounts[:, 23]                       # Nb + V
        b_tot = amounts[:, 50] + amounts[:, 13] + amounts[:, 14] + amounts[:, 32]
        ratio = a_tot / b_tot.clamp_min(1e-6)
        rules = (
            # B1 YBCO: oxygen below ~6.35
            ((fam == 2) & (o > 0) & (o < 6.35), cfg.b1_ybco_oxygen),
            # B2 LSCO: Sr doping outside [0.055, 0.27]
            ((fam == 3) & present[:, 38] & ((sr < 0.055) | (sr > 0.27)),
             cfg.b2_lsco_sr_doping),
            # B3 BSCCO: |Ca - (Cu - 1)| > 0.3
            ((fam == 4) & present[:, 20] & present[:, 29]
             & ((ca - (cu - 1.0)).abs() > 0.3), cfg.b3_bscco_ca_cu),
            # B4 Hg-cuprate: V > 30%
            ((fam == 6) & (v_amt > 0.30), cfg.b4_hg_volatile),
            # B5 Tl-cuprate: V > 30%, Li > 10%, any magnetic 3d > 10%
            ((fam == 5) & (v_amt > 0.30), cfg.b5_tl_poison),
            ((fam == 5) & (li > 0.10), cfg.b5_tl_poison),
            ((fam == 5) & mag10, cfg.b5_tl_poison),
            # B6 iron-1111: O present but < 0.7 and != 1.0
            ((fam == 8) & present[:, 8] & (o < 0.7) & (o != 1.0), cfg.b6_iron_oxygen),
            # B7 MgB2: C > 12.5%, Al > 50%, magnetic 3d > 5%
            ((fam == 10) & (c_amt > 0.125), cfg.b7_mgb2_poison),
            ((fam == 10) & (al > 0.50), cfg.b7_mgb2_poison),
            ((fam == 10) & mag05, cfg.b7_mgb2_poison),
            # B8 A15: (Nb+V) : (Sn+Al+Si+Ge) should be 3:1 +/- 10%
            ((fam == 1) & (a_tot > 0) & (b_tot > 0) & ((ratio - 3.0).abs() > 0.3),
             cfg.b8_a15_ratio),
        )
        fpen = torch.zeros_like(pen)
        for hit, penalty in rules:
            fpen = fpen + hit * penalty
        pen = pen + torch.where(gate & (fpen < 0), fpen, torch.zeros_like(fpen))

    return pen


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
