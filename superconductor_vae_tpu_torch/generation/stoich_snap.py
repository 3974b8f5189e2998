"""Rational snap of predicted stoichiometry conditioning (port of
generation/stoich_snap.py).

The decoder is hypersensitive to small conditioning error in the 13-dim
stoich vector, and corpus stoich values are exact rationals (normalised
element shares of (p/q)-amount formulas), so the fraction head's
predictions sit a small distance from a low-denominator rational.  Snapping
each slot to its best bounded-denominator rational removes that distance
whenever the head is within half a grid step.  A fixed scan over candidate
denominators, as whole-batch tensor ops.
"""

from __future__ import annotations

import torch

# candidate denominators for normalized SHARES: all integers up to 64 (a
# share's denominator is the formula's total amount scale, e.g. 2/13 for
# Cu in YBa2Cu3O7) plus the training vocab's larger common denominators
_SNAP_DENOMS = tuple(range(1, 65)) + (80, 100, 125, 200, 250, 1000)


def rational_snap_stoich(stoich: torch.Tensor, tol: float = 2.5e-3) -> torch.Tensor:
    """Snap a [B, 13] stoich conditioning vector (12 normalized fraction
    slots + element count) onto the rational grid.

    Each slot share is replaced by the SMALLEST-denominator rational p/q
    within ``tol`` of it; if no candidate is within tol the slot keeps its
    minimum-error candidate.  Shares are renormalized to sum to 1 over
    nonzero slots (the raw shares are kept if every slot snapped to zero)
    and the trailing element count is rounded to the nearest integer in
    [1, 12].  Identity for inputs already on the grid."""
    frac = stoich[:, :-1]                                  # [B, 12]
    count = stoich[:, -1:]                                 # [B, 1]
    q = torch.tensor(_SNAP_DENOMS, dtype=torch.float32, device=stoich.device)
    p = torch.round(frac[..., None] * q)                   # [B, 12, Q]
    cand = p / q
    err = (cand - frac[..., None]).abs()
    within = err <= tol
    # argmax takes the FIRST maximum (q ascending => smallest denominator)
    first_ok = within.to(torch.uint8).argmax(dim=-1)
    best = torch.where(within.any(dim=-1), first_ok, err.argmin(dim=-1))   # [B, 12]
    snapped = cand.gather(-1, best[..., None])[..., 0].clamp(0.0, 1.0)
    total = snapped.sum(dim=-1, keepdim=True)
    snapped = torch.where(total > 0, snapped / total.clamp_min(1e-9), frac)
    count_r = torch.round(count).clamp(1.0, float(frac.shape[1]))
    return torch.cat([snapped, count_r], dim=1)
