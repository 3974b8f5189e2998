"""Reward parameters of REINFORCE (the ``RewardConfig`` of ops/reward.py).

Only the dataclass, which ``RLConfig`` carries; the reward itself comes
with the RL slice.
"""

from __future__ import annotations

import dataclasses


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
