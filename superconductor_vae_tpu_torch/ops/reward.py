"""REINFORCE reward, V14 continuous power-law (port of ops/reward.py).

Exact-match bonus; the length-only ("perfect prefix, too long") and
too-short special cases; a continuous ``max_reward * (n_correct /
n_total) ** sharpness`` base with token-type penalties, fraction-value
penalties through the tokenizer's LUT and a length-mismatch penalty; and
the batch novelty bonus.  Whole-batch tensor ops; rewards are targets and
carry no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tokenizer import (
    ELEMENT_TOKEN_START, EOS_ID, FRACTION_TOKEN_START, INTEGER_TOKEN_START,
)
from .token_stats import first_eos_position


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """V14 continuous reward parameters."""
    exact_match: float = 100.0
    max_reward: float = 100.0
    sharpness: float = 4.0
    element_error_penalty: float = -3.0
    integer_error_penalty: float = -1.0
    fraction_error_penalty: float = -0.5
    special_error_penalty: float = -0.5
    fraction_value_penalty: float = -10.0   # base for value-scaled fraction errs
    fraction_value_scale: float = 2.0
    length_mismatch_penalty: float = -2.0
    length_only_base_reward: float = 50.0
    length_only_per_extra: float = 5.0
    length_only_floor: float = 10.0
    too_short_base_reward: float = 50.0
    too_short_per_missing: float = 5.0
    too_short_floor: float = 10.0
    floor: float = -100.0


def _end_positions(tokens, mask):
    """(position of the first EOS within ``mask``, else the count of valid
    positions, as float; whether there is one), each [B]."""
    return first_eos_position(tokens, mask), ((tokens == EOS_ID) & mask).any(dim=1)


def fraction_value_penalty(sampled, target, mask, fraction_values,
                           base_penalty: float, scale: float) -> torch.Tensor:
    """Penalty scaled by |value(pred) - value(target)| at fraction
    mismatches. [B]."""
    v = fraction_values.shape[0]
    target_is_frac = (target >= FRACTION_TOKEN_START) & mask
    mism = (sampled != target) & target_is_frac
    diff = (fraction_values[sampled.clamp(0, v - 1)]
            - fraction_values[target.clamp(0, v - 1)]).abs()
    pen_scale = 1.0 + scale * diff.clamp(0.0, 20.0) / 20.0
    return (mism * base_penalty * pen_scale).sum(dim=1)


def token_type_penalties(sampled, target, mask, cfg: RewardConfig,
                         skip_fraction: bool) -> torch.Tensor:
    """Per-type penalties at mismatch positions, by the target's type. [B]."""
    mism = (sampled != target) & mask
    is_el = (target >= ELEMENT_TOKEN_START) & (target < INTEGER_TOKEN_START) & mism
    is_int = (target >= INTEGER_TOKEN_START) & (target < FRACTION_TOKEN_START) & mism
    is_frac = (target >= FRACTION_TOKEN_START) & mism
    is_special = mism & ~is_el & ~is_int & ~is_frac
    pen = (is_el.sum(dim=1) * cfg.element_error_penalty
           + is_int.sum(dim=1) * cfg.integer_error_penalty
           + is_special.sum(dim=1) * cfg.special_error_penalty)
    if not skip_fraction:
        pen = pen + is_frac.sum(dim=1) * cfg.fraction_error_penalty
    return pen


def compute_reward(
    sampled: torch.Tensor,            # [B, T] token ids
    target: torch.Tensor,             # [B, T] token ids
    mask: torch.Tensor,               # [B, T] float/bool (valid positions)
    cfg: RewardConfig = RewardConfig(),
    fraction_values: Optional[torch.Tensor] = None,  # [V] tokenizer LUT
) -> torch.Tensor:
    """[B] float32 rewards."""
    mask = mask.bool()
    b, t = sampled.shape

    matches = (sampled == target) & mask
    exact = ((sampled != target) & mask).sum(dim=1) == 0

    sampled_end, sampled_has_end = _end_positions(sampled, mask)
    target_end, _ = _end_positions(target, mask)
    length_diff = (sampled_end - target_end).abs()

    if fraction_values is not None:
        frac_pen = fraction_value_penalty(
            sampled, target, mask, fraction_values,
            cfg.fraction_value_penalty, cfg.fraction_value_scale)
        skip_frac_type = True
    else:
        frac_pen = torch.zeros(b, device=sampled.device)
        skip_frac_type = False

    positions = torch.arange(t, device=sampled.device)[None, :].float()
    not_exact = ~exact

    # length-only: perfect prefix up to the target's END, sampled runs long
    before_tgt_end = positions < target_end[:, None]
    prefix_ok = ((sampled == target) | ~before_tgt_end | ~mask).all(dim=1)
    length_only = prefix_ok & (sampled_end > target_end) & not_exact
    extra = (sampled_end - target_end).clamp_min(0.0)
    lo_reward = (cfg.length_only_base_reward
                 - extra * cfg.length_only_per_extra).clamp_min(cfg.length_only_floor)

    # too-short: perfect prefix up to the sampled END, END emitted early
    before_smp_end = positions < sampled_end[:, None]
    prefix_smp_ok = ((sampled == target) | ~before_smp_end | ~mask).all(dim=1)
    too_short = (sampled_end < target_end) & sampled_has_end
    ts_case = prefix_smp_ok & too_short & not_exact & ~length_only
    missing = (target_end - sampled_end).clamp_min(0.0)
    ts_reward = (cfg.too_short_base_reward
                 - missing * cfg.too_short_per_missing).clamp_min(cfg.too_short_floor)

    # continuous base over the content tokens (up to and incl. target END)
    content_len = (target_end + 1.0).clamp_min(1.0)
    at_or_before = positions <= target_end[:, None]
    content_matches = (matches & at_or_before).sum(dim=1).float()
    ratio = (content_matches / content_len).clamp(0.0, 1.0)
    continuous = cfg.max_reward * ratio ** cfg.sharpness

    type_pen = token_type_penalties(sampled, target, mask, cfg, skip_frac_type)
    length_pen = length_diff * cfg.length_mismatch_penalty
    general = (continuous + type_pen + frac_pen + length_pen).clamp_min(cfg.floor)

    rewards = torch.where(exact, torch.full_like(general, cfg.exact_match), general)
    rewards = torch.where(length_only, lo_reward, rewards)
    return torch.where(ts_case, ts_reward, rewards)


@torch.no_grad()
def batch_novelty_bonus(
    sampled: torch.Tensor,            # [B, T] token ids
    mask: torch.Tensor,               # [B, T] valid-token mask
    vocab_size: int,
    k_nearest: int = 5,
    weight: float = 0.1,
) -> torch.Tensor:
    """[B] bonuses in [0, weight]: one minus the mean token-set Jaccard
    similarity of each row to its ``k_nearest`` most similar rows of the
    batch, through one [B, V] x [V, B] product."""
    b = sampled.shape[0]
    # a token is present if any of its occurrences is valid
    presence = torch.zeros(b, vocab_size, device=sampled.device).scatter_reduce_(
        1, sampled.long(), mask.float(), reduce='amax', include_self=True)
    inter = presence @ presence.T                               # [B, B]
    counts = presence.sum(dim=1)
    union = counts[:, None] + counts[None, :] - inter
    jaccard = inter / union.clamp_min(1.0)
    # exclude self-similarity, take the k most similar neighbours
    jaccard = jaccard - 2.0 * torch.eye(b, device=sampled.device)
    k = min(k_nearest, max(b - 1, 1))
    top_sim = jaccard.topk(k, dim=1).values
    return weight * (1.0 - top_sim.clamp(0.0, 1.0).mean(dim=1))
