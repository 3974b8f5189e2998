"""Cyclical KL annealing + free-bits KL, legacy VAE-era utilities (port of
training/kl_annealing.py).

The active model is deterministic (the encoder's "kl_loss" is an L2
z-regularizer), so nothing in the training loop consumes these; they are
here because the JAX package has them (reference:
training/kl_annealing.py:27-272).  The schedule is a host-side controller
(plain floats per epoch); the two KL losses are tensor ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ['CyclicalKLScheduler', 'kl_loss', 'kl_loss_free_bits',
           'KLLossWithAnnealing']


@dataclass
class CyclicalKLScheduler:
    """β(epoch) schedule: 'cyclical' repeats a ramp+plateau n_cycles times,
    'monotonic' ramps once then holds, 'constant' is fixed max_beta
    (reference: kl_annealing.py:38-123)."""
    n_epochs: int = 300
    n_cycles: int = 4
    warmup_epochs: int = 10
    cycle_ratio: float = 0.5
    min_beta: float = 0.0
    max_beta: float = 1.0
    schedule_type: str = 'cyclical'

    def __post_init__(self):
        self.effective_epochs = self.n_epochs - self.warmup_epochs
        self.cycle_length = (self.effective_epochs / self.n_cycles
                             if self.n_cycles > 0 else self.effective_epochs)

    def get_beta(self, epoch: int) -> float:
        if self.schedule_type == 'constant':
            return self.max_beta
        if epoch < self.warmup_epochs:
            return self.min_beta
        adj = epoch - self.warmup_epochs
        if self.schedule_type == 'monotonic':
            ramp = self.effective_epochs * self.cycle_ratio
            if adj >= ramp:
                return self.max_beta
            return self.min_beta + (adj / ramp) * (self.max_beta
                                                   - self.min_beta)
        if self.schedule_type == 'cyclical':
            pos = adj % self.cycle_length
            ramp = self.cycle_length * self.cycle_ratio
            if pos >= ramp:
                return self.max_beta
            return self.min_beta + (pos / ramp) * (self.max_beta
                                                   - self.min_beta)
        raise ValueError(f'unknown schedule_type: {self.schedule_type}')

    def get_full_schedule(self) -> np.ndarray:
        return np.asarray([self.get_beta(e) for e in range(self.n_epochs)])


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) || N(0,I)) summed over latent dims, batch-averaged
    (reference: kl_annealing.py:156-176)."""
    per_sample = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar), dim=1)
    return per_sample.mean()


def kl_loss_free_bits(mu: torch.Tensor, logvar: torch.Tensor,
                      free_bits: float = 0.5) -> torch.Tensor:
    """Free-bits KL: each latent dim contributes at least ``free_bits``
    nats, preventing per-dimension posterior collapse
    (reference: kl_annealing.py:178-203)."""
    per_dim = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))
    return per_dim.clamp_min(free_bits).sum(dim=1).mean()


class KLLossWithAnnealing:
    """Scheduler + loss in one callable: (weighted, raw, beta) per epoch
    (reference: kl_annealing.py:206-272)."""

    def __init__(self, n_epochs: int = 300, n_cycles: int = 4,
                 warmup_epochs: int = 10, cycle_ratio: float = 0.5,
                 max_beta: float = 1.0, use_free_bits: bool = False,
                 free_bits: float = 0.5, schedule_type: str = 'cyclical'):
        self.scheduler = CyclicalKLScheduler(
            n_epochs=n_epochs, n_cycles=n_cycles,
            warmup_epochs=warmup_epochs, cycle_ratio=cycle_ratio,
            max_beta=max_beta, schedule_type=schedule_type)
        self.use_free_bits = use_free_bits
        self.free_bits = free_bits

    def __call__(self, mu, logvar, epoch: int):
        raw = (kl_loss_free_bits(mu, logvar, self.free_bits)
               if self.use_free_bits else kl_loss(mu, logvar))
        beta = self.scheduler.get_beta(epoch)
        return beta * raw, raw, beta
