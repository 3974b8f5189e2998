"""Theory-guided regularization losses, routed per superconductor family
(port of ops/theory.py).

Soft physics priors that penalize Tc predictions inconsistent with the
family's theory: the Allen-Dynes envelope for BCS and MgB2, the Presland
dome for cuprates, a cap for iron-based and organic superconductors and a
log-normal prior for heavy fermions.  All terms are batch-masked
``torch.where`` routings on the 14-class family labels.  The train step
computes it at weight 0, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from ..models.family_classifier import SuperconductorFamily as F


@dataclasses.dataclass(frozen=True)
class TheoryConfig:
    bcs_theta_d: float = 300.0       # typical Debye temperature envelope (K)
    bcs_lambda_max: float = 2.0      # strong-coupling envelope
    bcs_mu_star: float = 0.1
    cuprate_tc_max: float = 135.0
    cuprate_dome_width: float = 82.6
    cuprate_p_opt: float = 0.16
    iron_tc_max: float = 56.0
    hf_log_mean: float = 0.4         # ln(1.5 K)
    hf_log_std: float = 1.0
    organic_tc_cap: float = 15.0
    soft: bool = True                # quadratic soft penalties (no hard caps)


def _bcs_tc_cap(cfg: TheoryConfig) -> float:
    lam, mu = cfg.bcs_lambda_max, cfg.bcs_mu_star
    return (cfg.bcs_theta_d / 1.2) * math.exp(
        -1.04 * (1 + lam) / (lam - mu * (1 + 0.62 * lam)))


def theory_loss(
    tc_pred_kelvin: torch.Tensor,      # [B] predicted Tc in Kelvin
    family: torch.Tensor,              # [B] 14-class labels
    element_fractions: torch.Tensor,   # [B, E] normalized fractions
    element_indices: torch.Tensor,     # [B, E] atomic numbers
    element_mask: torch.Tensor,        # [B, E]
    cfg: TheoryConfig = TheoryConfig(),
) -> Dict[str, torch.Tensor]:
    tc = tc_pred_kelvin.clamp_min(0.0)
    fam = family
    m = element_mask.float()
    zero = torch.zeros_like(tc)

    def soft_excess(x, cap):
        # a number is filled on the device: copied from the host, it would
        # make the host wait for the device
        cap = (torch.as_tensor(cap, dtype=x.dtype, device=x.device)
               if isinstance(cap, torch.Tensor)
               else torch.full((), cap, dtype=x.dtype, device=x.device))
        e = (x - cap).clamp_min(0.0) / cap.clamp_min(1.0)
        return e ** 2

    # BCS / MgB2: Allen-Dynes envelope cap
    is_bcs = (fam == F.BCS_CONVENTIONAL) | (fam == F.MGB2_TYPE)
    bcs = torch.where(is_bcs, soft_excess(tc, max(_bcs_tc_cap(cfg), 40.0)), zero)

    # Cuprates: Presland dome; doping proxy = fraction of Sr and Ca
    is_cup = (fam >= F.CUPRATE_YBCO) & (fam <= F.CUPRATE_OTHER)
    dopant = (((element_indices == 38) | (element_indices == 20)).float()
              * element_fractions * m)
    p = dopant.sum(dim=1).clamp(0.0, 0.4)
    dome = cfg.cuprate_tc_max * (
        1.0 - cfg.cuprate_dome_width * (p - cfg.cuprate_p_opt) ** 2).clamp(0.0, 1.0)
    dome_cap = dome.clamp_min(0.3 * cfg.cuprate_tc_max)
    cup = torch.where(is_cup, soft_excess(tc, cfg.cuprate_tc_max * 1.2), zero)
    cup = cup + torch.where(is_cup, 0.25 * soft_excess(tc, dome_cap), zero)

    # Iron: cap at iron_tc_max
    is_iron = (fam == F.IRON_PNICTIDE) | (fam == F.IRON_CHALCOGENIDE)
    iron = torch.where(is_iron, soft_excess(tc, cfg.iron_tc_max * 1.2), zero)

    # Heavy fermion: log-normal prior around ~1.5 K
    log_tc = torch.log(tc.clamp_min(0.05))
    hf = torch.where(fam == F.HEAVY_FERMION,
                     ((log_tc - cfg.hf_log_mean) / cfg.hf_log_std) ** 2 * 0.1, zero)

    # Organic: soft cap ~15 K
    org = torch.where(fam == F.ORGANIC, soft_excess(tc, cfg.organic_tc_cap), zero)

    per_family = {
        'bcs': bcs.mean(), 'cuprate': cup.mean(), 'iron': iron.mean(),
        'heavy_fermion': hf.mean(), 'organic': org.mean(),
    }
    return {'total': sum(per_family.values()), **per_family}
