"""Mastery-aware sampling and the length-bucket curriculum (port of
training/mastery_sampler.py).

Per-sample rolling true-AR accuracy drives the sampling weights toward
weak rows (with a replay floor and regression detection), and a
length-bucket curriculum multiplies the base weights to focus the AR
warm-up on the active difficulty frontier
(reference: mastery_sampler.py:245, curriculum_scheduler.py:24-223).
Host numpy, the JAX package's line for line.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class MasteryTracker:
    """Rolling per-sample exact-match mastery -> sampling weights."""

    def __init__(self, n_samples: int, ema: float = 0.8,
                 replay_floor: float = 0.2, regression_drop: float = 0.3):
        self.mastery = np.zeros(n_samples)      # EMA of per-sample success
        self.seen = np.zeros(n_samples, bool)
        self.peak = np.zeros(n_samples)
        self.ema = ema
        self.replay_floor = replay_floor
        self.regression_drop = regression_drop

    def update(self, indices: np.ndarray, correct: np.ndarray) -> None:
        c = correct.astype(np.float64)
        old = self.mastery[indices]
        new = np.where(self.seen[indices], self.ema * old + (1 - self.ema) * c, c)
        self.mastery[indices] = new
        self.seen[indices] = True
        self.peak[indices] = np.maximum(self.peak[indices], new)

    def regressed(self) -> np.ndarray:
        """Samples that dropped well below their peak mastery."""
        return self.seen & (self.mastery < self.peak - self.regression_drop)

    def weights(self) -> np.ndarray:
        """Focus weak examples; mastered ones keep a replay floor; regressed
        ones get boosted back."""
        w = 1.0 - self.mastery
        w = np.maximum(w, self.replay_floor)
        w[~self.seen] = 1.0
        w[self.regressed()] *= 2.0
        return w / w.sum()


class CurriculumScheduler:
    """Length-bucket AR curriculum (reference: curriculum_scheduler.py:24).

    Buckets by sequence length; the active bucket gets ``active_boost``, the
    next ``frontier_boost``; graduated buckets keep ``graduated_weight`` and
    not-yet-active ones ``floor_weight``.  Advances when the active bucket's
    AR exact clears the threshold for ``patience`` consecutive reports.
    """

    def __init__(self, seq_lengths: np.ndarray,
                 bucket_edges: Sequence[int] = (3, 7, 11, 16, 24, 32, 61),
                 advance_threshold: float = 0.5, advance_patience: int = 3,
                 active_boost: float = 3.0, frontier_boost: float = 1.5,
                 floor_weight: float = 0.2, graduated_weight: float = 0.5):
        self.edges = list(bucket_edges)
        # bucket i covers [edges[i], edges[i+1]); shorter-than-first-edge
        # sequences join bucket 0
        self.bucket = np.clip(np.digitize(seq_lengths, self.edges) - 1,
                              0, len(self.edges) - 1)
        self.n_buckets = len(self.edges)
        self.active = 0
        self.streak = 0
        self.advance_threshold = advance_threshold
        self.advance_patience = advance_patience
        self.active_boost = active_boost
        self.frontier_boost = frontier_boost
        self.floor_weight = floor_weight
        self.graduated_weight = graduated_weight

    def report_ar_exact(self, per_sample_exact: np.ndarray,
                        sample_indices: np.ndarray) -> None:
        in_active = self.bucket[sample_indices] == self.active
        if in_active.sum() == 0:
            return
        acc = per_sample_exact[in_active].mean()
        if acc >= self.advance_threshold:
            self.streak += 1
            if (self.streak >= self.advance_patience
                    and self.active < self.n_buckets - 1):
                self.active += 1
                self.streak = 0
        else:
            self.streak = 0

    def get_sample_weights(self) -> np.ndarray:
        w = np.full(len(self.bucket), self.floor_weight)
        w[self.bucket < self.active] = self.graduated_weight
        w[self.bucket == self.active] = self.active_boost
        if self.active + 1 < self.n_buckets:
            w[self.bucket == self.active + 1] = self.frontier_boost
        return w

    def state_dict(self) -> Dict:
        return {'active': self.active, 'streak': self.streak}

    def load_state_dict(self, state: Dict) -> None:
        self.active = state['active']
        self.streak = state['streak']
