"""Latent-space navigation strategies over ``[N, latent]`` batches (port of
generation/latent.py).

Gaussian perturbation, SLERP / linear interpolation, centroid walks, PCA
walks and element-anchored neighbour blending, as tensor ops (the PCA and
the Jaccard neighbours are host numpy, as in JAX).  A function that draws
random numbers takes a ``torch.Generator`` and hands its draws to a
deterministic core (``_perturb``, ``_blend``), so that a caller can feed
the core draws of its own.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _perturb(z: torch.Tensor, noise: torch.Tensor, sigma: float) -> torch.Tensor:
    return z + sigma * noise


def perturb(z: torch.Tensor, generator: torch.Generator, sigma: float) -> torch.Tensor:
    """Gaussian perturbation around anchor latents."""
    noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
    return _perturb(z, noise, sigma)


def slerp(z0: torch.Tensor, z1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation, batched over the leading dims of ``t`` (a
    [N] ``t`` takes row i of [N, latent] anchors to ``t[i]``); linear where
    the vectors are nearly collinear."""
    z0n = z0 / (torch.linalg.vector_norm(z0, dim=-1, keepdim=True) + 1e-8)
    z1n = z1 / (torch.linalg.vector_norm(z1, dim=-1, keepdim=True) + 1e-8)
    dot = (z0n * z1n).sum(-1, keepdim=True).clamp(-1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    t = torch.as_tensor(t, dtype=z0.dtype, device=z0.device)
    if t.dim():
        t = t[..., None]
    near = so.abs() < 1e-6
    safe = torch.where(near, torch.ones_like(so), so)
    s0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * omega) / safe)
    s1 = torch.where(near, t, torch.sin(t * omega) / safe)
    return s0 * z0 + s1 * z1


def lerp(z0: torch.Tensor, z1: torch.Tensor, t) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=z0.dtype, device=z0.device)
    if t.dim():
        t = t[..., None]
    return (1.0 - t) * z0 + t * z1


def interpolation_sweep(z0: torch.Tensor, z1: torch.Tensor, n: int,
                        spherical: bool = True) -> torch.Tensor:
    """n interpolants between two anchors. [n, latent]."""
    ts = torch.linspace(0.0, 1.0, n, dtype=z0.dtype, device=z0.device)
    return (slerp if spherical else lerp)(z0, z1, ts)


def centroid_walk(z_anchor: torch.Tensor, centroid: torch.Tensor,
                  steps: torch.Tensor) -> torch.Tensor:
    """Walk from an anchor toward (and past) a cluster centroid."""
    direction = centroid - z_anchor
    return z_anchor[None] + steps[:, None] * direction[None]


def pca_walk(z_anchor: torch.Tensor, components: torch.Tensor,
             magnitudes: torch.Tensor) -> torch.Tensor:
    """Walk along principal directions. components [K, latent],
    magnitudes [N, K] -> [N, latent]."""
    return z_anchor[None] + magnitudes @ components


def pca_components(z_cache: np.ndarray, k: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k principal directions + explained std of a z cache (host-side)."""
    zc = z_cache - z_cache.mean(axis=0, keepdims=True)
    # SVD on [N, D]: rows of Vt are components
    _, s, vt = np.linalg.svd(zc, full_matrices=False)
    std = s / np.sqrt(max(len(zc) - 1, 1))
    return vt[:k], std[:k]


def _blend(z_anchor: torch.Tensor, z_neighbors: torch.Tensor, idx: torch.Tensor,
           ts: torch.Tensor, noise: torch.Tensor, sigma: float,
           slerp_fraction: float) -> torch.Tensor:
    """``element_anchored_blend`` on given draws: partner indices ``idx``
    [n], interpolation weights ``ts`` [n] and standard normal ``noise``
    [n, latent]."""
    n = idx.shape[0]
    partners = z_neighbors[idx]
    use_slerp = torch.arange(n, device=idx.device) < int(n * slerp_fraction)
    blended_s = slerp(z_anchor[None], partners, ts)
    centroid = z_neighbors.mean(dim=0)
    blended_c = lerp(((z_anchor + centroid) / 2)[None], partners, ts)
    blended = torch.where(use_slerp[:, None], blended_s, blended_c)
    return blended + sigma * noise


def element_anchored_blend(
    z_anchor: torch.Tensor,          # [latent]
    z_neighbors: torch.Tensor,       # [M, latent] chemically similar anchors
    generator: torch.Generator,
    n: int,
    sigma: float = 0.05,
    slerp_fraction: float = 0.3,
) -> torch.Tensor:
    """Blend an anchor with its element-sharing neighbours + noise
    (reference: self_supervised.py phase-2 strategy 4)."""
    kw = dict(generator=generator, device=z_anchor.device)
    idx = torch.randint(0, z_neighbors.shape[0], (n,), **kw)
    ts = 0.2 + 0.6 * torch.rand(n, dtype=z_anchor.dtype, **kw)
    noise = torch.randn(n, z_anchor.shape[-1], dtype=z_anchor.dtype, **kw)
    return _blend(z_anchor, z_neighbors, idx, ts, noise, sigma, slerp_fraction)


def element_jaccard_neighbors(
    element_sets_target: np.ndarray,    # [E] bool presence over Z for target
    element_presence: np.ndarray,       # [N, E] bool presence per dataset row
    k: int = 32,
    min_shared: int = 2,
) -> np.ndarray:
    """Indices of the k most element-similar dataset rows (Jaccard)
    (reference: scripts/holdout/holdout_search_targeted.py:364)."""
    inter = (element_presence & element_sets_target[None]).sum(axis=1)
    union = (element_presence | element_sets_target[None]).sum(axis=1)
    jac = inter / np.maximum(union, 1)
    jac[inter < min_shared] = -1.0
    order = np.argsort(-jac)
    return order[:k][jac[order[:k]] > 0]
