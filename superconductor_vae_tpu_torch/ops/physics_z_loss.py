"""Physics-Z supervision: tie named latent coordinates to physical targets
(port of ops/physics_z_loss.py).

Sub-losses:

  comp      Block 8 coordinates against the 15 compositional targets
  magpie    Block 11 (450-512) against a projection of the Magpie
            features: the learnable ``nn.Linear(magpie_dim, 62)`` made by
            ``init_magpie_proj`` and trained with the encoder, or with
            ``proj=None`` a fixed seeded near-isometry (numpy seed 1234)
  thermo    z[TC] against the normalized input Tc, transition ordering
  gl/bcs/cobordism/ratios/structural/electronic
            internal consistency identities between named coordinates
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models import physics_z as PZ
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PhysicsZConfig:
    comp_weight: float = 1.0
    magpie_weight: float = 0.5
    consistency_weight: float = 0.1
    new_consistency_weight: float = 0.05


def _magpie_projection(magpie_dim: int, out_dim: int = 62) -> np.ndarray:
    """Deterministic near-isometric projection magpie -> Block 11 coords."""
    rng = np.random.default_rng(1234)
    m = rng.normal(0, 1, (magpie_dim, out_dim)).astype(np.float32)
    # unit-norm columns for a stable target scale
    m /= np.linalg.norm(m, axis=0, keepdims=True) + 1e-8
    return m


@functools.cache
def _device_tables(device: torch.device, magpie_dim: int):
    """(Block 8 coordinates, fixed Magpie projection) on ``device``, made
    once: a copy from the host would wait for the device on every call."""
    return (torch.as_tensor(PZ.COMP_COORDS, device=device),
            torch.as_tensor(_magpie_projection(magpie_dim), device=device))


def init_magpie_proj(generator: torch.Generator, magpie_dim: int,
                     out_dim: int = 62, device='cuda',
                     dtype=torch.float32) -> nn.Linear:
    """The learnable Linear(magpie_dim -> out_dim) of the Magpie term, with
    torch's default ``nn.Linear`` distribution (weight and bias uniform in
    +-1/sqrt(fan_in)), drawn on the CPU from ``generator``."""
    device = resolve_device(device)
    proj = nn.Linear(magpie_dim, out_dim, device=device, dtype=dtype)
    bound = 1.0 / math.sqrt(magpie_dim)
    with torch.no_grad():
        for p in (proj.weight, proj.bias):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
    return proj


def _huber(pred: torch.Tensor, target: torch.Tensor,
           delta: float = 1.0) -> torch.Tensor:
    """SmoothL1, mean over the batch."""
    d = pred - target
    a = d.abs()
    return torch.where(a < delta, 0.5 * d * d / delta, a - 0.5 * delta).mean()


def _c(x: torch.Tensor, lo: float = -100.0, hi: float = 100.0) -> torch.Tensor:
    """Clamp derived targets while Z coordinates are still random."""
    return x.clamp(lo, hi)


def gl_consistency(z: torch.Tensor) -> torch.Tensor:
    """Ginzburg-Landau identities: kappa=lam/xi, Hc~1/(lam*xi),
    Hc2~1/xi^2, E_cond~Hc^2, Hc1~ln(kappa)/lam^2."""
    xi = z[:, PZ.XI].clamp_min(0.01)
    lam = z[:, PZ.LAMBDA_L].clamp_min(0.01)
    kappa = z[:, PZ.KAPPA]
    hc = z[:, PZ.HC]
    loss = _huber(kappa, _c(lam / xi))
    loss = loss + _huber(hc, _c(1.0 / (lam * xi)))
    loss = loss + _huber(z[:, PZ.HC2], _c(1.0 / xi ** 2))
    loss = loss + _huber(z[:, PZ.E_COND], _c(hc.detach() ** 2))
    loss = loss + _huber(z[:, PZ.HC1],
                         _c(torch.log(kappa.clamp_min(1.01)) / lam ** 2))
    return loss


def bcs_consistency(z: torch.Tensor) -> torch.Tensor:
    """BCS identities: xi~v_F/Delta0, gap ratio soft-bounded to [1, 5]."""
    vf = z[:, PZ.V_F].clamp_min(0.01)
    d0 = z[:, PZ.DELTA0].clamp_min(0.01)
    gap = z[:, PZ.GAP_RATIO]
    loss = _huber(z[:, PZ.XI], _c(vf / d0))
    return loss + (gap - 5.0).clamp_min(0.0).mean() + (1.0 - gap).clamp_min(0.0).mean()


def cobordism_consistency(z: torch.Tensor) -> torch.Tensor:
    """Block 9 defect energies from GL parameters."""
    kappa = z[:, PZ.KAPPA]
    lam = z[:, PZ.LAMBDA_L].clamp_min(0.01)
    ev, ed = z[:, PZ.E_VORTEX], z[:, PZ.E_DOMAIN]
    loss = _huber(ev, _c(torch.log(kappa.clamp_min(1.01)) / lam ** 2))
    loss = loss + _huber(ed, z[:, PZ.SIGMA_NS])
    loss = loss + _huber(z[:, PZ.TYPE_I_II], kappa.detach() - 2.0 ** -0.5)
    loss = loss + _huber(z[:, PZ.E_DEFECT_MIN], torch.minimum(ev.detach(), ed.detach()))
    return loss


def ratio_consistency(z: torch.Tensor) -> torch.Tensor:
    """Block 10 cross-block ratios: Tc/Theta_D and xi/l_mfp."""
    loss = _huber(z[:, PZ.TC_THETA_D],
                  _c(z[:, PZ.TC] / z[:, PZ.THETA_D].clamp_min(0.01)))
    return loss + _huber(z[:, PZ.XI_L],
                         _c(z[:, PZ.XI] / z[:, PZ.L_MFP].clamp_min(0.01)))


def thermo_consistency(z: torch.Tensor,
                       tc_normalized: Optional[torch.Tensor]) -> torch.Tensor:
    """Block 7: z[TC] matches the input Tc, onset >= midpoint >= zero,
    Delta_Tc = onset - zero."""
    onset, mid = z[:, PZ.TC_ONSET], z[:, PZ.TC_MIDPOINT]
    zero = z[:, PZ.TC_ZERO]
    loss = torch.zeros((), dtype=z.dtype, device=z.device)
    if tc_normalized is not None:
        loss = loss + _huber(z[:, PZ.TC], tc_normalized)
    loss = loss + (mid - onset).clamp_min(0.0).mean()
    loss = loss + (zero - mid).clamp_min(0.0).mean()
    return loss + _huber(z[:, PZ.DELTA_TC], onset.detach() - zero.detach())


def structural_consistency(z: torch.Tensor) -> torch.Tensor:
    """Block 5: volume ~ a*b*c."""
    a = z[:, PZ.LATTICE_A].clamp_min(0.01)
    b = z[:, PZ.LATTICE_B].clamp_min(0.01)
    c = z[:, PZ.LATTICE_C].clamp_min(0.01)
    return _huber(z[:, PZ.VOLUME], _c(a * b * c))


def electronic_consistency(z: torch.Tensor) -> torch.Tensor:
    """Block 6: Drude weight ~ plasma_freq^2."""
    return _huber(z[:, PZ.DRUDE_WEIGHT], _c(z[:, PZ.PLASMA_FREQ].detach() ** 2))


def physics_z_loss(
    z: torch.Tensor,                 # [B, 2048]
    comp_targets: torch.Tensor,      # [B, 15] normalized
    magpie: torch.Tensor,            # [B, M] normalized
    tc_normalized: torch.Tensor,     # [B]
    cfg: PhysicsZConfig = PhysicsZConfig(),
    proj: Optional[nn.Linear] = None,
) -> Dict[str, torch.Tensor]:
    """The weighted physics-Z loss and its terms.  ``proj`` is the learnable
    Magpie projection (``init_magpie_proj``), or None for the fixed one."""
    coords, fixed = _device_tables(z.device, magpie.shape[1])
    comp = ((z[:, coords] - comp_targets) ** 2).mean()

    start, end = PZ.block('magpie')
    if proj is not None:
        target = proj(magpie)
    else:
        target = magpie @ fixed                                     # [B, 62]
    mag = ((z[:, start:end] - target) ** 2).mean()

    gl = gl_consistency(z)
    bcs = bcs_consistency(z)
    cob = cobordism_consistency(z)
    ratios = ratio_consistency(z)
    thermo = thermo_consistency(z, tc_normalized)
    struct = structural_consistency(z)
    elec = electronic_consistency(z)
    consistency = gl + bcs + cob + ratios
    new_consistency = thermo + struct + elec

    total = (cfg.comp_weight * comp + cfg.magpie_weight * mag
             + cfg.consistency_weight * consistency
             + cfg.new_consistency_weight * new_consistency)
    return {
        'total': total, 'comp': comp, 'magpie': mag,
        'gl': gl, 'bcs': bcs, 'cobordism': cob, 'ratios': ratios,
        'thermo': thermo, 'structural': struct, 'electronic': elec,
        'consistency': consistency,
    }
