"""Exact Hungarian assignment on the device by subset dynamic programming
(port of ops/hungarian.py).

The set decoder's loss matches its 12 slots to the ground-truth elements
by the exact min-cost perfect matching of a 12 x 12 cost matrix, solved
as the JAX package solves it, with bitmask DP over popcount levels:

    dp[S] = min_{j in S} dp[S \\ {j}] + cost[|S| - 1, j]

12 level updates cover the 2^12 subsets, and a 12-step backtrack through
the argmin pointers recovers the permutation.  Every level is a gather, an
add, a mask and a min over the whole batch on the device: no scipy, no
copy to the host, no wait for the card.  The level tables are built once
per device and kept.

Kept from the JAX function, so that the permutations are the same: the
constant ``_BIG`` for subsets a column is not in, the order of addition
``dp_prev[pred_rank] + cost[k, j]``, and the first index among equal
candidates (``jnp.argmin``'s rule, and ``torch.min``'s).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.global_batch import global_count, global_mean

_BIG = 1e9
PAD_COST = 1e4          # the cost of a padded ground-truth column


@functools.lru_cache(maxsize=None)
def _popcounts(n: int) -> np.ndarray:
    return np.array([bin(s).count('1') for s in range(1 << n)], np.int32)


@functools.lru_cache(maxsize=None)
def _level_tables(n: int):
    """Per popcount level k = 1..n: the subset ids, the rank (index within
    level k-1's array) of each predecessor S \\ {j}, and the j-in-S mask;
    and the global [2^n] subset id -> rank table for the backtrack."""
    pops = _popcounts(n)
    size = 1 << n
    rank = np.zeros(size, np.int32)
    for k in range(0, n + 1):
        ids = np.where(pops == k)[0]
        rank[ids] = np.arange(len(ids), dtype=np.int32)

    levels = []
    for k in range(1, n + 1):
        subsets = np.where(pops == k)[0].astype(np.int32)          # [M_k]
        preds = subsets[:, None] ^ (1 << np.arange(n))[None, :]    # [M_k, n]
        in_s = (subsets[:, None] & (1 << np.arange(n))[None, :]) > 0
        pred_rank = rank[preds].astype(np.int32)                   # [M_k, n]
        levels.append((subsets, pred_rank, in_s))
    return levels, rank


_DEVICE_TABLES: Dict[Tuple[int, str], Tuple[List, torch.Tensor, torch.Tensor]] = {}


def _device_tables(n: int, device: torch.device):
    """``_level_tables(n)`` as tensors on ``device``, built on first use.
    A predecessor rank outside level k-1 (j not in S: masked, as in JAX,
    where the gather clamps) is set to 0, so that the gather stays in
    bounds."""
    key = (n, str(device))
    if key not in _DEVICE_TABLES:
        levels, rank = _level_tables(n)
        dev_levels = []
        for _, pred_rank, in_s in levels:
            dev_levels.append((torch.as_tensor(np.where(in_s, pred_rank, 0),
                                               dtype=torch.long).to(device),
                               torch.as_tensor(in_s).to(device)))
        _DEVICE_TABLES[key] = (dev_levels,
                               torch.as_tensor(rank, dtype=torch.long).to(device),
                               (1 << torch.arange(n, dtype=torch.long)).to(device))
    return _DEVICE_TABLES[key]


def hungarian_assignment(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact min-cost perfect matching of each [n, n] matrix of ``cost``
    [B, n, n].  Returns (row_to_col [B, n] int64, total cost [B]); row i is
    the i-th assigned (the DP's cardinality order is the row order).  No
    gradient flows through the assignment."""
    cost = cost.detach()
    b, n, _ = cost.shape
    levels, rank, pow2 = _device_tables(n, cost.device)
    dp_prev = cost.new_zeros(b, 1)                     # level 0: the empty set
    parents = []
    for k, (pred_rank, in_s) in enumerate(levels):
        cand = (dp_prev[:, pred_rank] + cost[:, k, None, :]).masked_fill(~in_s, _BIG)
        dp_prev, j = cand.min(dim=2)                   # [B, M_k]; first index on ties
        parents.append(j)

    # backtrack: one subset a level, resolved through the rank table
    s = torch.full((b,), (1 << n) - 1, dtype=torch.long, device=cost.device)
    cols = []
    for k in range(n - 1, -1, -1):
        j = parents[k].gather(1, rank[s][:, None])[:, 0]
        cols.append(j)
        s = s ^ pow2[j]
    return torch.stack(cols[::-1], dim=1), dp_prev[:, 0]


def hungarian_matching_loss(
    element_logits: torch.Tensor,   # [B, S, 119], class 0 = empty
    fraction_pred: torch.Tensor,    # [B, S]
    presence_logits: torch.Tensor,  # [B, S]
    gt_elements: torch.Tensor,      # [B, E] atomic numbers (0 = pad)
    gt_fractions: torch.Tensor,     # [B, E]
    gt_mask: torch.Tensor,          # [B, E]
    element_weight: float = 1.0,
    fraction_weight: float = 5.0,
    no_object_weight: float = 0.1,
    presence_weight: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """The set-prediction loss with exact matching on the device: slots
    matched to ground-truth columns by element cross-entropy plus weighted
    fraction error (a padded column costs ``PAD_COST``), then element CE
    (empty targets at ``no_object_weight``), fraction MSE over real
    matches, presence BCE, and the accuracy and exact-set metrics."""
    b, s, _ = element_logits.shape
    logp = F.log_softmax(element_logits.float(), dim=-1)
    gt_e = gt_elements.clamp(0, 118).long()
    valid = gt_mask.float()

    # cost[b, slot, gt_col]: CE of each ground-truth element at each slot
    # plus the weighted fraction error
    ce = -logp.gather(2, gt_e[:, None, :].expand(b, s, gt_e.shape[1]))
    frac_err = (fraction_pred[:, :, None] - gt_fractions[:, None, :]) ** 2
    cost = element_weight * ce + fraction_weight * frac_err
    cost = cost.masked_fill(valid[:, None, :] <= 0, PAD_COST)

    perm, _ = hungarian_assignment(cost)               # [B, S] slot -> gt column

    matched_e = gt_e.gather(1, perm)
    matched_f = gt_fractions.gather(1, perm)
    matched_real = valid.gather(1, perm)               # 1 where the match is real
    real = matched_real > 0

    tgt = matched_e.masked_fill(~real, 0)
    nll = -logp.gather(2, tgt[..., None])[..., 0]
    w = torch.full_like(matched_real, no_object_weight).masked_fill(real, 1.0)
    element_loss = (nll * w).sum() / global_count(w.sum()).clamp_min(1.0)

    n_real = global_count(matched_real.sum()).clamp_min(1.0)
    frac_l = ((fraction_pred - matched_f) ** 2 * matched_real).sum() / n_real

    pres_logits = presence_logits.float()
    pres_bce = -(matched_real * F.logsigmoid(pres_logits)
                 + (1 - matched_real) * F.logsigmoid(-pres_logits))
    presence_loss = global_mean(pres_bce)

    total = (element_weight * element_loss + fraction_weight * frac_l
             + presence_weight * presence_loss)

    pred_e = element_logits.argmax(dim=-1)
    elem_correct = ((pred_e == matched_e) * matched_real).sum() / n_real
    set_exact = global_mean((((pred_e == tgt) | ~real)
                             & ((torch.sigmoid(pres_logits) > 0.5) == real)
                             ).all(dim=1).float())
    return {
        'total': total, 'element_loss': element_loss,
        'fraction_loss': frac_l, 'presence_loss': presence_loss,
        'element_accuracy': elem_correct, 'set_exact': set_exact,
    }
