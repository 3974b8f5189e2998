"""Candidate latent generation strategies (port of
generation/candidate_generator.py).

Latent gradient ascent on predicted Tc, cluster-centre sampling,
interpolation and evolutionary refinement, each over a whole ``[N,
latent]`` batch.  The ascent takes gradients with respect to z alone
(``torch.autograd.grad``): the encoder's parameters get no ``.grad`` and
are not changed, and the encoder runs in eval mode and gets its mode back.
Draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import MaterialsEncoder
from ..models.layers import eval_mode
from .latent import interpolation_sweep, perturb


class CandidateGenerator:
    def __init__(self, encoder: MaterialsEncoder):
        self.encoder = encoder
        self.device = next(encoder.parameters()).device

    def _as_z(self, z) -> torch.Tensor:
        return torch.as_tensor(z, dtype=torch.float32, device=self.device)

    def tc_grad(self, z: torch.Tensor) -> torch.Tensor:
        """d(sum of predicted Tc)/dz, the encoder in eval mode."""
        z = self._as_z(z).detach().requires_grad_(True)
        with eval_mode(self.encoder):
            tc = self.encoder.decode(z)['tc_pred'].float().sum()
            return torch.autograd.grad(tc, z)[0]

    def gradient_ascent_tc(self, z_init, steps: int = 20, lr: float = 0.5,
                           max_norm_growth: float = 1.3) -> torch.Tensor:
        """Push latents toward higher predicted Tc with normalised steps,
        bounded by a norm trust region so candidates stay on the data
        manifold."""
        z = self._as_z(z_init)
        cap = torch.linalg.vector_norm(z, dim=-1, keepdim=True) * max_norm_growth
        for _ in range(steps):
            g = self.tc_grad(z)
            z = z + lr * g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-8)
            norm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
            z = torch.where(norm > cap, z * cap / norm, z)
        return z

    def sample_clusters(self, centers: np.ndarray, n_per_cluster: int,
                        sigma: float, generator: torch.Generator) -> torch.Tensor:
        """Gaussian sampling around cluster centres. [K*n, latent]."""
        reps = self._as_z(centers).repeat_interleave(n_per_cluster, dim=0)
        return perturb(reps, generator, sigma)

    def interpolate_pairs(self, z_a, z_b, n: int = 8,
                          spherical: bool = True) -> torch.Tensor:
        """Interpolants between high-Tc pairs, flattened. [P*n, latent]."""
        z_a, z_b = self._as_z(z_a), self._as_z(z_b)
        sweep = torch.stack([interpolation_sweep(a, b, n, spherical)
                             for a, b in zip(z_a, z_b)])
        return sweep.reshape(-1, z_a.shape[-1])

    def evolutionary(self, z_pop, generator: torch.Generator, generations: int = 5,
                     elite_frac: float = 0.25, sigma: float = 0.1) -> torch.Tensor:
        """Evolve a latent population toward higher predicted Tc: keep the
        elite by predicted Tc, refill with mutated crossovers (uniform
        weights between two elite parents, then Gaussian noise)."""
        z = self._as_z(z_pop)
        n = z.shape[0]
        n_elite = max(int(n * elite_frac), 2)
        kw = dict(generator=generator, device=self.device)
        for _ in range(generations):
            with torch.no_grad(), eval_mode(self.encoder):
                tc = self.encoder.decode(z)['tc_pred'].float()
            elite = z[torch.argsort(-tc, stable=True)[:n_elite]]
            pa = elite[torch.randint(0, n_elite, (n - n_elite,), **kw)]
            pb = elite[torch.randint(0, n_elite, (n - n_elite,), **kw)]
            alpha = torch.rand(n - n_elite, 1, **kw)
            children = perturb(alpha * pa + (1 - alpha) * pb, generator, sigma)
            z = torch.cat([elite, children], dim=0)
        return z

    def predicted_tc(self, z) -> np.ndarray:
        with torch.no_grad(), eval_mode(self.encoder):
            return self.encoder.decode(self._as_z(z))['tc_pred'].float().cpu().numpy()
