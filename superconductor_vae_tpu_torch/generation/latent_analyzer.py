"""Latent-space analysis: the latent cache and high-Tc cluster discovery
(port of generation/latent_analyzer.py).

``build_cache`` runs the encoder over the dataset in eval mode without
gradients, in fixed-size batches (the last padded with row 0, as the JAX
sweep pads it); the clustering is host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..data.pipeline import DatasetArrays


@dataclasses.dataclass
class LatentCache:
    z: np.ndarray               # [N, latent]
    tc_pred: np.ndarray         # [N]
    tc_kelvin: np.ndarray       # [N] ground truth Kelvin
    is_sc: np.ndarray
    family: np.ndarray
    formulas: List[str]


def _sq_dists(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """[n, k] squared distances without the [n, k, d] broadcast tensor."""
    return ((x * x).sum(-1)[:, None] + (centers * centers).sum(-1)[None, :]
            - 2.0 * (x @ centers.T))


def _kmeans(x: np.ndarray, k: int, iters: int = 50,
            seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    assign = np.zeros(len(x), np.int32)
    for _ in range(iters):
        d = _sq_dists(x, centers)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(len(centers)):
            sel = assign == c
            if sel.any():
                centers[c] = x[sel].mean(0)
    return assign, centers


class LatentSpaceAnalyzer:
    def __init__(self, encoder: torch.nn.Module):
        self.encoder = encoder

    @torch.no_grad()
    def build_cache(self, ds: DatasetArrays, batch_size: int = 512) -> LatentCache:
        """z and tc_pred of every row of ``ds``, with the rows' true Tc in
        Kelvin, labels and formulas.  Leaves the encoder in the mode it
        found it in."""
        enc = self.encoder
        device = next(enc.parameters()).device
        was_training = enc.training
        enc.eval()
        zs, tcs = [], []
        n = len(ds)
        try:
            for b in range(0, n, batch_size):
                idx = np.arange(b, min(b + batch_size, n))
                pad = batch_size - len(idx)
                full = np.concatenate([idx, np.zeros(pad, np.int64)]) if pad else idx
                batch = ds.batch(full)
                out = enc(*(torch.as_tensor(batch[k]).to(device) for k in (
                    'element_indices', 'element_fractions', 'element_mask', 'magpie', 'tc')))
                zs.append(out['z'].float().cpu().numpy()[:len(idx)])
                tcs.append(out['tc_pred'].float().cpu().numpy()[:len(idx)])
        finally:
            enc.train(was_training)
        return LatentCache(
            z=np.concatenate(zs), tc_pred=np.concatenate(tcs),
            tc_kelvin=ds.norm_stats.tc_to_kelvin(ds.tc),
            is_sc=ds.is_sc, family=ds.family, formulas=ds.formulas)

    def find_high_tc_clusters(self, cache: LatentCache, k: int = 9,
                              tc_threshold: float = 30.0) -> List[Dict]:
        """K-means over SC latents; rank clusters by mean true Tc."""
        sel = (cache.is_sc == 1)
        z = cache.z[sel]
        tc = cache.tc_kelvin[sel]
        if len(z) < k:
            return []
        assign, centers = _kmeans(z.astype(np.float64), k)
        clusters = []
        for c in range(len(centers)):
            members = assign == c
            if not members.any():
                continue
            clusters.append({
                'center': centers[c].astype(np.float32),
                'n_members': int(members.sum()),
                'mean_tc': float(tc[members].mean()),
                'max_tc': float(tc[members].max()),
                'high_tc': float(tc[members].mean()) >= tc_threshold,
                'member_indices': np.where(sel)[0][members],
            })
        return sorted(clusters, key=lambda c: -c['mean_tc'])
