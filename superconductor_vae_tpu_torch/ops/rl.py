"""Policy-gradient configuration (the ``RLConfig`` of ops/rl.py).

Only the dataclass, which ``TrainConfig`` carries; SCST/RLOO, the
rollouts and the TF re-score come with the RL slice.
"""

from __future__ import annotations

import dataclasses

from .constraints import ConstraintConfig
from .reward import RewardConfig


@dataclasses.dataclass(frozen=True)
class RLConfig:
    method: str = 'scst'              # 'scst' | 'rloo'
    n_samples_rloo: int = 4
    temperature: float = 1.2
    entropy_weight: float = 0.2
    max_len: int = 30
    stop_boost: float = 10.0
    hard_stop_threshold: float = 0.8
    site_dup_threshold: float = 0.0
    use_type_masking: bool = True
    reward: RewardConfig = RewardConfig()
    constraints: ConstraintConfig = ConstraintConfig()
    use_constraint_rewards: bool = True
    # batch-Jaccard novelty bonus (0 = off)
    novelty_weight: float = 0.0
    novelty_k: int = 5
    # rollouts are gradient-free, so sampling may stop once every row has
    early_exit: bool = True
