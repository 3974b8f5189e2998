"""Z-space coverage tracking for Phase-2 sampling (port of
training/coverage_tracker.py: host numpy, the same logic).

As the reference ``CoverageTracker``
(reference: src/superconductor/training/coverage_tracker.py:22-475): k-means
(k=64) over the latent cache, exponentially-decayed visit counts, inverse
-visit sampling weights, and per-cluster quality stats.

Beyond the reference: ``fit(method='hdbscan')`` clusters the cache with
density-based HDBSCAN (PCA-reduced, as in analysis/topology.py) so coverage
cells follow the latent manifold's natural structure instead of a fixed-k
Voronoi partition (k-means where sklearn lacks HDBSCAN or is absent, as JAX
falls back; ``fitted_with`` says which ran), and ``sampling_weights``
blends inverse-visit exploration with the per-cluster quality EMA so Phase-2 favors under-visited regions
that historically produce chemically valid candidates.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class CoverageTracker:
    def __init__(self, k: int = 64, temperature: float = 1.0,
                 decay: float = 0.995, seed: int = 0,
                 quality_alpha: float = 1.0):
        self.k = k
        self.temperature = temperature
        self.decay = decay
        self.seed = seed
        # exponent on the quality term of the sampling weights; 0 = pure
        # inverse-visit coverage (the round-1 behavior)
        self.quality_alpha = quality_alpha
        self.centers: Optional[np.ndarray] = None
        self.visits: Optional[np.ndarray] = None
        self.quality: Optional[np.ndarray] = None
        self.quality_seen: Optional[np.ndarray] = None
        self.fitted_with: Optional[str] = None     # 'hdbscan' or 'kmeans'

    def _init_state(self, centers: np.ndarray) -> None:
        self.centers = centers
        self.visits = np.zeros(len(centers))
        self.quality = np.zeros(len(centers))
        self.quality_seen = np.zeros(len(centers), bool)

    def fit(self, z_cache: np.ndarray, iters: int = 25,
            method: str = 'kmeans') -> None:
        from ..utils.npz import as_f32
        z_cache = as_f32(z_cache)
        if method == 'hdbscan':
            centers = self._hdbscan_centers(z_cache)
            if centers is not None and len(centers) >= 4:
                self._init_state(centers)
                self.fitted_with = 'hdbscan'
                return
            # fall through to k-means when HDBSCAN degenerates (all noise,
            # too few clusters) or sklearn lacks it
        rng = np.random.default_rng(self.seed)
        k = min(self.k, len(z_cache))
        centers = z_cache[rng.choice(len(z_cache), k, replace=False)].copy()
        for _ in range(iters):
            assign = self.assign(z_cache, centers)
            for c in range(k):
                sel = assign == c
                if sel.any():
                    centers[c] = z_cache[sel].mean(0)
        self._init_state(centers)
        self.fitted_with = 'kmeans'

    def _hdbscan_centers(self, z_cache: np.ndarray) -> Optional[np.ndarray]:
        """Density-based coverage cells: HDBSCAN over a PCA reduction of the
        cache (same recipe as analysis/topology.py hdbscan_metrics); cluster
        centroids in FULL z-space become the coverage centers.  Noise points
        are ignored — under-dense filaments stay reachable via the nearest
        -center assignment."""
        try:
            from sklearn.cluster import HDBSCAN
        except ImportError:                                # pragma: no cover
            return None
        if len(z_cache) < 64:
            return None
        zc = z_cache - z_cache.mean(0, keepdims=True)
        dim = min(32, zc.shape[1], len(zc) - 1)
        _, _, vt = np.linalg.svd(zc[
            np.random.default_rng(self.seed).choice(
                len(zc), min(len(zc), 4096), replace=False)],
            full_matrices=False)
        red = zc @ vt[:dim].T
        min_sz = max(5, len(z_cache) // 200)
        labels = HDBSCAN(min_cluster_size=min_sz).fit(red).labels_
        ids = np.unique(labels[labels >= 0])
        if len(ids) == 0:
            return None
        return np.stack([z_cache[labels == c].mean(0) for c in ids])

    @staticmethod
    def assign(z: np.ndarray, centers: Optional[np.ndarray] = None) -> np.ndarray:
        d = ((z * z).sum(-1)[:, None] + (centers * centers).sum(-1)[None, :]
             - 2.0 * (z @ centers.T))
        return d.argmin(1)

    def record_visits(self, z: np.ndarray,
                      quality: Optional[np.ndarray] = None) -> None:
        assert self.centers is not None, 'call fit() first'
        self.visits *= self.decay
        assign = self.assign(z, self.centers)
        for c in assign:
            self.visits[c] += 1
        if quality is not None:
            for c, q in zip(assign, quality):
                # first observation seeds the EMA so a cluster's quality
                # doesn't have to climb from the 0 placeholder
                if self.quality_seen is not None and not self.quality_seen[c]:
                    self.quality[c] = float(q)
                    self.quality_seen[c] = True
                else:
                    self.quality[c] = 0.9 * self.quality[c] + 0.1 * float(q)

    def sampling_weights(self) -> np.ndarray:
        """Per-cluster weights: inverse-visit exploration × quality EMA.

        Clusters never scored keep a neutral quality prior (0.5) so pure
        exploration still reaches them; ``quality_alpha=0`` recovers the
        pure coverage weighting."""
        assert self.visits is not None
        w = 1.0 / (1.0 + self.visits) ** self.temperature
        if self.quality_alpha > 0 and self.quality is not None:
            q = np.where(self.quality_seen, self.quality, 0.5) \
                if self.quality_seen is not None else self.quality
            w = w * (0.25 + np.clip(q, 0.0, 1.0)) ** self.quality_alpha
        return w / w.sum()

    def sample_cluster(self, rng: np.random.Generator) -> int:
        return int(rng.choice(len(self.centers), p=self.sampling_weights()))

    def stats(self) -> Dict[str, float]:
        v = self.visits
        return {
            'n_clusters': len(self.centers) if self.centers is not None else 0,
            'visited_fraction': float((v > 0).mean()) if v is not None else 0.0,
            'visit_gini': float(np.abs(v[:, None] - v[None]).mean()
                                / (2 * v.mean() + 1e-8)) if v is not None else 0.0,
        }
