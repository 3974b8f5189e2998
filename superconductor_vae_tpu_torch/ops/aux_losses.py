"""Auxiliary representation losses (port of ops/aux_losses.py): supervised
contrastive (SupCon) over the encoder's latents, self-consistency and
bidirectional consistency.  All three ship at weight 0 in the reference's
config; ``multitask_loss`` adds SupCon when ``supcon_weight > 0``.

Plain PyTorch expressions on whatever device the inputs are on; the
gradients flow through autograd.  SupCon's "no positive in the batch"
guard is a ``where``, so a batch without one gives a finite 0.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def supcon_loss(z: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.07,
                base_temperature: float = 0.07) -> torch.Tensor:
    """Supervised contrastive loss over latents ``z`` [B, D] with integer
    ``labels`` [B]: positives share a label (self excluded), every other
    row is a contrast candidate.  A scalar; 0 for B <= 1."""
    b = z.shape[0]
    if b <= 1:
        return torch.zeros((), device=z.device, dtype=z.dtype)
    zn = z / torch.linalg.vector_norm(z, dim=1, keepdim=True).clamp_min(1e-12)
    sim = (zn @ zn.T) / temperature                        # [B, B]
    eye = torch.eye(b, dtype=torch.bool, device=z.device)
    pos_mask = (labels[:, None] == labels[None, :]) & ~eye
    # row-max subtraction; the max carries no gradient almost everywhere
    sim = sim - sim.max(dim=1, keepdim=True).values
    exp_sim = torch.where(eye, torch.zeros_like(sim), torch.exp(sim))
    log_prob = sim - torch.log(exp_sim.sum(dim=1, keepdim=True) + 1e-8)
    pos_count = pos_mask.sum(dim=1)
    mean_log_prob = (torch.where(pos_mask, log_prob, torch.zeros_like(log_prob)).sum(dim=1)
                     / pos_count.clamp_min(1))
    mean_log_prob = torch.where(pos_count > 0, mean_log_prob,
                                torch.zeros_like(mean_log_prob))
    return (-(temperature / base_temperature) * mean_log_prob).mean()


def _huber(err: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(err <= delta, 0.5 * err ** 2, delta * (err - 0.5 * delta))


def self_consistency_loss(
    original_tc: torch.Tensor, reconstructed_tc: torch.Tensor,
    original_magpie: Optional[torch.Tensor] = None,
    reconstructed_magpie: Optional[torch.Tensor] = None,
    tc_weight: float = 1.0, magpie_weight: float = 0.1,
    normalize_magpie: bool = True, huber_delta: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Agreement of the properties predicted from the input with those
    re-predicted from the reconstruction: MSE (``huber_delta=None``) or
    Huber on Tc, MSE on the (row-normalised) Magpie vectors.  Returns
    {'tc_consistency', 'magpie_consistency', 'total'}."""
    o = original_tc.reshape(-1)
    r = reconstructed_tc.reshape(-1)
    if huber_delta is None:
        tc_loss = ((r - o) ** 2).mean()
    else:
        tc_loss = _huber((r - o).abs(), huber_delta).mean()
    tc_loss = tc_loss * tc_weight
    if original_magpie is not None and reconstructed_magpie is not None:
        om, rm = original_magpie, reconstructed_magpie
        if normalize_magpie:
            om = om / torch.linalg.vector_norm(om, dim=-1, keepdim=True).clamp_min(1e-12)
            rm = rm / torch.linalg.vector_norm(rm, dim=-1, keepdim=True).clamp_min(1e-12)
        magpie_loss = ((rm - om) ** 2).mean() * magpie_weight
    else:
        magpie_loss = torch.zeros((), device=tc_loss.device, dtype=tc_loss.dtype)
    return {'tc_consistency': tc_loss, 'magpie_consistency': magpie_loss,
            'total': tc_loss + magpie_loss}


def bidirectional_consistency_loss(
    original_tc: torch.Tensor, pred_tc_from_reconstruction: torch.Tensor,
    tc_weight: float = 1.0, huber_delta: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Ground-truth Tc against the Tc re-predicted through the whole
    encode-decode-re-encode loop (the caller supplies it).  Returns
    {'bidirectional_consistency', 'tc_error_mean', 'tc_error_std'}, the
    standard deviation with one degree of freedom (0 for one row)."""
    o = original_tc.reshape(-1)
    p = pred_tc_from_reconstruction.reshape(-1)
    err = (o - p).abs()
    if huber_delta is None:
        loss = ((p - o) ** 2).mean()
    else:
        loss = _huber(err, huber_delta).mean()
    std = (err.std(correction=1) if err.shape[0] > 1
           else torch.zeros((), device=err.device, dtype=err.dtype))
    return {'bidirectional_consistency': loss * tc_weight,
            'tc_error_mean': err.mean(), 'tc_error_std': std}
