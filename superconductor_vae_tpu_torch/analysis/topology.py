"""Latent-space topology analysis (port of analysis/topology.py, host
numpy).

Intrinsic dimension (MLE and correlation dimension), kNN density, the
SC/non-SC boundary, cluster topology (k-means, and HDBSCAN where sklearn
is installed: without it ``hdbscan_metrics`` returns its empty result, as
the JAX package's does), the PCA spectrum and pairwise-distance
statistics, with a compact JSONL snapshot a call and, on demand, the
per-sample arrays.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def _pairwise_sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[n, m] squared distances via the |a|^2 + |b|^2 - 2ab identity —
    never materializes an [n, m, d] broadcast tensor (at d=2048 that
    would be terabytes)."""
    a2 = (a * a).sum(-1)[:, None]
    b2 = (b * b).sum(-1)[None, :]
    return np.maximum(a2 + b2 - 2.0 * (a @ b.T), 0.0)


def _knn_distances(x: np.ndarray, k: int, sample: int = 1024,
                   seed: int = 0) -> np.ndarray:
    """[n, k] sorted distances to the k nearest neighbors (subsampled)."""
    rng = np.random.default_rng(seed)
    idx = (rng.choice(len(x), sample, replace=False)
           if len(x) > sample else np.arange(len(x)))
    q = x[idx]
    d2 = _pairwise_sq(q, x)
    d2[np.arange(len(q)), idx] = np.inf  # self
    part = np.partition(d2, k, axis=1)[:, :k]
    return np.sqrt(np.sort(part, axis=1))


def intrinsic_dimension_mle(x: np.ndarray, k: int = 20) -> float:
    """Levina-Bickel MLE intrinsic dimension."""
    d = _knn_distances(x, k)
    d = np.clip(d, 1e-12, None)
    logs = np.log(d[:, -1][:, None] / d[:, :-1])
    inv = logs.mean(axis=1)
    return float(1.0 / np.clip(inv, 1e-12, None).mean())


def correlation_dimension(x: np.ndarray, n_r: int = 10,
                          sample: int = 1024, seed: int = 0) -> float:
    """Grassberger-Procaccia correlation dimension (log-log slope)."""
    rng = np.random.default_rng(seed)
    idx = (rng.choice(len(x), sample, replace=False)
           if len(x) > sample else np.arange(len(x)))
    q = x[idx]
    d = np.sqrt(_pairwise_sq(q, q))
    d = d[np.triu_indices(len(q), 1)]
    d = d[d > 0]
    if len(d) < 10:
        return 0.0
    rs = np.logspace(np.log10(np.percentile(d, 5)),
                     np.log10(np.percentile(d, 50)), n_r)
    counts = np.array([(d < r).mean() for r in rs])
    valid = counts > 0
    if valid.sum() < 3:
        return 0.0
    slope = np.polyfit(np.log(rs[valid]), np.log(counts[valid]), 1)[0]
    return float(slope)


def boundary_metrics(z: np.ndarray, is_sc: np.ndarray, k: int = 20,
                     heterogeneity_threshold: float = 0.3,
                     sample: int = 4096, seed: int = 0) -> Dict[str, object]:
    """SC/non-SC boundary detection via kNN label heterogeneity
    (reference: analysis/boundary_detector.py:25-146).

    Boundary samples = those whose k-neighborhood holds > threshold
    fraction of opposite-label points; thickness = mean distance from a
    boundary sample to its nearest opposite-label neighbor.  Subsampled,
    vectorized (no per-sample Python loop as in the reference).

    Returns metrics plus the per-sample ``heterogeneity`` array (full tier).
    """
    is_sc = np.asarray(is_sc).astype(bool)
    rng = np.random.default_rng(seed)
    idx = (rng.choice(len(z), sample, replace=False)
           if len(z) > sample else np.arange(len(z)))
    zq, lq = z[idx], is_sc[idx]
    if lq.all() or not lq.any():
        return {'boundary_thickness': 0.0, 'boundary_n_samples': 0,
                'boundary_fraction': 0.0, 'heterogeneity': np.zeros(len(idx))}
    d2 = _pairwise_sq(zq, zq)
    np.fill_diagonal(d2, np.inf)
    nn = np.argpartition(d2, k, axis=1)[:, :k]                  # [n, k]
    nd = np.sqrt(np.take_along_axis(d2, nn, axis=1))
    nl = lq[nn]
    hetero = (nl != lq[:, None]).mean(axis=1)
    bmask = hetero > heterogeneity_threshold
    if bmask.any():
        opp = nl[bmask] != lq[bmask, None]
        dopp = np.where(opp, nd[bmask], np.inf)
        thick = float(np.mean(dopp.min(axis=1)[np.isfinite(dopp.min(axis=1))]))
    else:
        thick = 0.0
    return {'boundary_thickness': thick,
            'boundary_n_samples': int(bmask.sum()),
            'boundary_fraction': float(bmask.mean()),
            'heterogeneity': hetero}


def hdbscan_metrics(z_sc: np.ndarray, tc_sc: Optional[np.ndarray] = None,
                    min_cluster_size: int = 50, pca_dims: int = 20,
                    seed: int = 42) -> Dict[str, object]:
    """HDBSCAN density-based clustering over the SC subset with PCA
    pre-reduction (reference: analysis/hdbscan_topology.py:28-245):
    natural cluster count, noise fraction, silhouette, largest-cluster
    share and its Tc range, plus per-cluster quality stats.

    Returns metrics + the per-sample ``labels`` array (full tier).
    """
    empty = {'hdbscan_n_clusters': 0, 'hdbscan_noise_fraction': 1.0,
             'hdbscan_silhouette': 0.0,
             'hdbscan_largest_cluster_fraction': 0.0,
             'hdbscan_tc_range_largest': 0.0, 'hdbscan_clusters': [],
             'labels': np.full(len(z_sc), -1)}
    if len(z_sc) < max(min_cluster_size * 2, 16):
        return empty
    try:
        from sklearn.cluster import HDBSCAN
        from sklearn.decomposition import PCA
        from sklearn.metrics import silhouette_score
    except ImportError:                       # pragma: no cover
        return empty

    z_red = PCA(n_components=min(pca_dims, z_sc.shape[1], len(z_sc) - 1),
                random_state=seed).fit_transform(np.asarray(z_sc, np.float64))
    labels = HDBSCAN(min_cluster_size=min_cluster_size,
                     metric='euclidean').fit_predict(z_red)
    ids = sorted(set(labels) - {-1})
    out: Dict[str, object] = dict(empty, labels=labels)
    out['hdbscan_n_clusters'] = len(ids)
    out['hdbscan_noise_fraction'] = float((labels == -1).mean())
    if not ids:
        return out
    clustered = labels >= 0
    if len(ids) >= 2 and clustered.sum() > len(ids):
        out['hdbscan_silhouette'] = float(
            silhouette_score(z_red[clustered], labels[clustered]))
    sizes = {c: int((labels == c).sum()) for c in ids}
    largest = max(sizes, key=sizes.get)
    out['hdbscan_largest_cluster_fraction'] = sizes[largest] / len(labels)
    # per-cluster quality (reference: compute_hdbscan_full)
    clusters = []
    for c in ids:
        m = labels == c
        rec = {'id': int(c), 'size': sizes[c],
               'spread': float(z_red[m].std(axis=0).mean())}
        if tc_sc is not None:
            tcs = np.asarray(tc_sc)[m]
            rec.update(tc_mean=float(tcs.mean()), tc_std=float(tcs.std()),
                       tc_range=float(tcs.max() - tcs.min()))
            if c == largest:
                out['hdbscan_tc_range_largest'] = rec['tc_range']
        clusters.append(rec)
    out['hdbscan_clusters'] = clusters
    return out


class TopologyAnalyzer:
    def __init__(self, k: int = 20, n_clusters: int = 9,
                 output_dir: Optional[str | Path] = None):
        self.k = k
        self.n_clusters = n_clusters
        self.output_dir = Path(output_dir) if output_dir else None

    def analyze(self, z: np.ndarray, is_sc: Optional[np.ndarray] = None,
                tc_kelvin: Optional[np.ndarray] = None,
                epoch: Optional[int] = None,
                full: bool = False) -> Dict[str, object]:
        z = np.asarray(z, np.float64)
        out: Dict[str, object] = {'n_samples': len(z), 'epoch': epoch,
                                  'time': time.time()}

        # intrinsic dimension (global + per-class, reference snapshot fields)
        out['intrinsic_dim_mle'] = intrinsic_dimension_mle(z, self.k)
        out['correlation_dim'] = correlation_dimension(z)
        if is_sc is not None and (is_sc == 1).sum() > self.k + 1:
            out['intrinsic_dim_mle_sc'] = intrinsic_dimension_mle(
                z[is_sc == 1], self.k)
        if is_sc is not None and (is_sc == 0).sum() > self.k + 1:
            out['intrinsic_dim_mle_nonsc'] = intrinsic_dimension_mle(
                z[is_sc == 0], self.k)

        # density: kNN radius stats
        knn = _knn_distances(z, self.k)
        out['knn_radius_mean'] = float(knn[:, -1].mean())
        out['knn_radius_std'] = float(knn[:, -1].std())

        # PCA spectrum
        zc = z - z.mean(0, keepdims=True)
        s = np.linalg.svd(zc, compute_uv=False)
        var = s ** 2 / max(len(z) - 1, 1)
        ratio = var / var.sum()
        out['pca_var_top8'] = ratio[:8].tolist()
        out['pca_effective_rank'] = float(
            np.exp(-(ratio * np.log(np.clip(ratio, 1e-12, None))).sum()))

        # pairwise distance stats
        rng = np.random.default_rng(0)
        n = min(len(z), 1024)
        sub = z[rng.choice(len(z), n, replace=False)]
        d = np.sqrt(_pairwise_sq(sub, sub))
        tri = d[np.triu_indices(n, 1)]
        out['pairwise_mean'] = float(tri.mean())
        out['pairwise_std'] = float(tri.std())
        from scipy.stats import kurtosis, skew
        out['pairwise_skewness'] = float(skew(tri))
        out['pairwise_kurtosis'] = float(kurtosis(tri))
        out['z_norm_mean'] = float(np.linalg.norm(z, axis=1).mean())

        # SC/non-SC boundary metrics (centroid + kNN-heterogeneity tiers)
        hetero = None
        if is_sc is not None and (is_sc == 0).any() and (is_sc == 1).any():
            sc_z, non_z = z[is_sc == 1], z[is_sc == 0]
            c_sc, c_non = sc_z.mean(0), non_z.mean(0)
            sep = np.linalg.norm(c_sc - c_non)
            spread = 0.5 * (sc_z.std(0).mean() + non_z.std(0).mean())
            out['sc_boundary_separation'] = float(sep)
            out['sc_boundary_ratio'] = float(sep / max(spread, 1e-8))
            bm = boundary_metrics(z, is_sc, k=self.k)
            hetero = bm.pop('heterogeneity')
            out.update(bm)

        # cluster topology over SC points: fixed-k kmeans (family tracking)
        # + HDBSCAN natural clustering (structure discovery)
        assign = None
        hdb_labels = None
        if is_sc is not None and (is_sc == 1).sum() >= self.n_clusters:
            from ..generation.latent_analyzer import _kmeans
            sc_z = z[is_sc == 1]
            tc_sc = tc_kelvin[is_sc == 1] if tc_kelvin is not None else None
            assign, centers = _kmeans(sc_z, self.n_clusters)
            sizes = np.bincount(assign, minlength=len(centers))
            out['cluster_sizes'] = sizes.tolist()
            # per-cluster quality: intra spread, inter-centroid distances,
            # Tc stats (reference: cluster_topology.compute_cluster_full)
            intra = [float(np.sqrt(_pairwise_sq(
                sc_z[assign == c], centers[c:c + 1])).mean())
                for c in range(len(centers)) if (assign == c).any()]
            out['intra_cluster_distance_mean'] = float(np.mean(intra))
            cd = np.sqrt(_pairwise_sq(centers, centers))
            out['inter_cluster_distance_mean'] = float(
                cd[np.triu_indices(len(centers), 1)].mean())
            if tc_sc is not None:
                out['cluster_mean_tc'] = [
                    float(tc_sc[assign == c].mean()) if (assign == c).any()
                    else 0.0 for c in range(len(centers))]
                out['cluster_tc_range'] = [
                    float(tc_sc[assign == c].max() - tc_sc[assign == c].min())
                    if (assign == c).any() else 0.0
                    for c in range(len(centers))]
            hdb = hdbscan_metrics(
                sc_z, tc_sc,
                min_cluster_size=max(10, min(50, len(sc_z) // 40)))
            hdb_labels = hdb.pop('labels')
            out.update(hdb)

        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            with open(self.output_dir / 'topology_summary.jsonl', 'a') as f:
                f.write(json.dumps(out) + '\n')
            if full:
                # full tier: per-sample arrays for best-checkpoint analysis
                # (reference: topology_metadata_epochNNNN.pt)
                arrays = {'knn_radius': knn[:, -1],
                          'z_norm': np.linalg.norm(z, axis=1)}
                if hetero is not None:
                    arrays['boundary_heterogeneity'] = hetero
                if assign is not None:
                    arrays['kmeans_labels'] = assign
                if hdb_labels is not None:
                    arrays['hdbscan_labels'] = hdb_labels
                np.savez_compressed(
                    self.output_dir / f'topology_full_{epoch or 0}.npz',
                    **arrays)
        return out
