"""Weighted epoch sampling and data-parallel index sharding (port of
data/sampler.py).

A numpy generator emits whole epochs of batch indices, seeded per epoch
from ``(seed, epoch)``, so a stream depends on nothing but the seed, the
epoch and the weights: the same index stream as the JAX package's, bit
for bit.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class WeightedEpochSampler:
    """Weighted sampling WITH replacement, one epoch = len(dataset) draws."""

    def __init__(self, weights: np.ndarray, batch_size: int,
                 seed: int = 0, drop_last: bool = True):
        self.weights = np.asarray(weights, np.float64)
        self.weights = self.weights / self.weights.sum()
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.n = len(self.weights)

    def set_weights(self, weights: np.ndarray) -> None:
        w = np.asarray(weights, np.float64)
        self.weights = w / w.sum()

    def n_batches(self) -> int:
        return (self.n // self.batch_size if self.drop_last
                else -(-self.n // self.batch_size))

    def epoch(self, epoch_idx: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng((self.seed, epoch_idx))
        idx = rng.choice(self.n, size=self.n, replace=True, p=self.weights)
        for b in range(self.n_batches()):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]


def shard_batch_indices(batch_idx: np.ndarray, host_id: int,
                        n_hosts: int) -> np.ndarray:
    """Keep this host's contiguous shard of a global batch."""
    per_host = len(batch_idx) // n_hosts
    return batch_idx[host_id * per_host:(host_id + 1) * per_host]
