"""Composition -> Magpie-style feature vector, pure numpy (copied from
chem/featurize.py).

The corpus's Magpie columns are this module's descriptor: 6 weighted
statistics (mean, avg. abs. deviation, min, max, range, mode of the most
abundant element) over each of the 11 element properties of
:mod:`chem.elements` (66), stoichiometric descriptors (element count, Lp
norms for p = 2, 3, 5, 7, 10, the Shannon entropy of the fractions: 7), and
the d- and f-electron shares of the mean valence count with the mean, max
and min atomic number (5): 78 features a composition.  The holdout search
computes a fresh target's Magpie vector with it
(generation/holdout_search.py).  The cross-featurizer bridge maps this
layout onto another corpus's Magpie columns by least squares.  Values are
the JAX package's, unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .elements import (N_PROPERTIES, PROPERTY_NAMES, SYMBOL_TO_Z,
                       element_property_matrix)

_STATS = ('mean', 'avg_dev', 'min', 'max', 'range', 'mode')

FEATURE_NAMES: List[str] = (
    [f'magpie_{p}_{s}' for p in PROPERTY_NAMES for s in _STATS]
    + ['n_elements', 'norm_p2', 'norm_p3', 'norm_p5', 'norm_p7', 'norm_p10',
       'frac_entropy']
    + ['d_electron_frac', 'f_electron_frac', 'z_mean', 'z_max', 'z_min']
)
N_FEATURES = len(FEATURE_NAMES)

_VALENCE_COL = PROPERTY_NAMES.index('valence')
_D_COL = PROPERTY_NAMES.index('d_electrons')
_F_COL = PROPERTY_NAMES.index('f_electrons')


def composition_features(comp: Dict[str, float]) -> np.ndarray:
    """[N_FEATURES] float32 descriptor for one {symbol: amount} composition.

    Unknown symbols are dropped; an empty/unknown composition returns zeros.
    """
    props = element_property_matrix(normalize=False)
    zs = np.array([SYMBOL_TO_Z[s] for s in comp if s in SYMBOL_TO_Z],
                  dtype=np.int64)
    amounts = np.array([comp[s] for s in comp if s in SYMBOL_TO_Z],
                       dtype=np.float64)
    if zs.size == 0 or amounts.sum() <= 0:
        return np.zeros((N_FEATURES,), np.float32)
    fracs = amounts / amounts.sum()
    mat = props[zs]                                      # [E, P]

    mean = fracs @ mat
    avg_dev = fracs @ np.abs(mat - mean[None, :])
    mn = mat.min(axis=0)
    mx = mat.max(axis=0)
    mode = mat[np.argmax(fracs)]
    stats = np.stack([mean, avg_dev, mn, mx, mx - mn, mode], axis=1)  # [P, 6]

    norms = [np.sum(fracs ** p) ** (1.0 / p) for p in (2, 3, 5, 7, 10)]
    entropy = float(-(fracs * np.log(np.clip(fracs, 1e-12, 1.0))).sum())

    val_mean = float(mean[_VALENCE_COL])
    d_frac = float(mean[_D_COL]) / max(val_mean + mean[_D_COL] + mean[_F_COL],
                                       1e-9)
    f_frac = float(mean[_F_COL]) / max(val_mean + mean[_D_COL] + mean[_F_COL],
                                       1e-9)
    z_stats = [float(fracs @ zs), float(zs.max()), float(zs.min())]

    out = np.concatenate([
        stats.reshape(-1),
        [len(zs)], norms, [entropy],
        [d_frac, f_frac], z_stats,
    ])
    assert out.shape == (N_FEATURES,)
    return out.astype(np.float32)


def formula_features(formula: str) -> np.ndarray:
    """[N_FEATURES] descriptor straight from a formula string."""
    from ..data.pipeline import parse_formula_composition
    return composition_features(parse_formula_composition(formula))


def featurize_formulas(formulas: Sequence[str]) -> np.ndarray:
    """[N, N_FEATURES] matrix for a list of formulas."""
    return np.stack([formula_features(f) for f in formulas])


# ---- cross-featurizer bridge -------------------------------------------------

def fit_magpie_bridge(ref_csv, out_path=None, limit: int | None = None
                      ) -> Dict[str, np.ndarray]:
    """Fit a least-squares linear map from THIS module's descriptor layout
    to a reference corpus' Magpie column layout.

    Both describe the same compositions, so a linear bridge fit on a corpus
    that carries the reference columns lets a checkpoint trained on those
    columns read corpora featurized natively.  The reference columns are
    the CSV's numeric columns outside the pipeline's
    ``NON_FEATURE_COLUMNS``, read as the pipeline reads a corpus (the
    standard library's csv module, pandas' missing cells and dtypes).

    Returns {'w': [N_FEATURES+1, M] (last row = bias), 'columns': [M] str,
    'r2': [M] per-column fit quality} and saves them to ``out_path``.
    """
    from ..data.pipeline import NON_FEATURE_COLUMNS, _read_csv_columns

    columns = _read_csv_columns(ref_csv)
    n = len(columns['formula'])
    n = min(n, limit) if limit else n
    cols = [c for c, v in columns.items()
            if v.dtype == np.float64 and c not in NON_FEATURE_COLUMNS]
    y = np.stack([columns[c][:n] for c in cols], axis=1).astype(np.float64)

    feats = []
    ok = []
    for f in columns['formula'][:n]:
        f = str(f)
        try:
            feats.append(formula_features(f))
            ok.append(True)
        except Exception:
            feats.append(np.zeros(N_FEATURES))
            ok.append(False)
    x = np.asarray(feats, np.float64)
    keep = (np.asarray(ok) & np.isfinite(x).all(axis=1)
            & np.isfinite(y).all(axis=1))
    x, y = x[keep], y[keep]

    xb = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    w, *_ = np.linalg.lstsq(xb, y, rcond=None)
    pred = xb @ w
    ss_res = ((y - pred) ** 2).sum(axis=0)
    ss_tot = ((y - y.mean(axis=0)) ** 2).sum(axis=0) + 1e-12
    r2 = 1.0 - ss_res / ss_tot

    bridge = {'w': w.astype(np.float32),
              'columns': np.asarray(cols),
              'r2': r2.astype(np.float32)}
    if out_path is not None:
        np.savez_compressed(out_path, **bridge)
    return bridge


def load_magpie_bridge(path) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def apply_magpie_bridge(feats: np.ndarray, bridge: Dict[str, np.ndarray]
                        ) -> np.ndarray:
    """[N, N_FEATURES] native features -> [N, M] reference-layout features."""
    w = bridge['w']
    if feats.shape[1] != w.shape[0] - 1:
        raise ValueError(
            f'bridge expects {w.shape[0] - 1} input features, '
            f'got {feats.shape[1]}')
    xb = np.concatenate(
        [feats, np.ones((len(feats), 1), feats.dtype)], axis=1)
    return (xb @ w).astype(np.float32)
