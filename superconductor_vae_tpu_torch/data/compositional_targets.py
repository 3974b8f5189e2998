"""Compositional supervision targets for the physics-Z latent block (port
of data/compositional_targets.py; numpy on the host, as the data
pipeline computes them).

15 formula-derived features of every sample, as dense-LUT gathers over
``[B, E]`` composition arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..chem.elements import element_property_matrix, PROPERTY_NAMES

COMP_TARGET_NAMES = (
    'n_elements', 'mw', 'x_h', 'z_avg', 'z_max', 'en_avg', 'en_diff',
    'r_avg', 'r_ratio', 'vec', 'd_orbital_frac', 'f_orbital_frac',
    'ie_avg', 'tm_avg', 'delta_size',
)
N_COMP_TARGETS = len(COMP_TARGET_NAMES)

_RAW = element_property_matrix(normalize=False)
_EN = _RAW[:, PROPERTY_NAMES.index('electronegativity')]
_RADIUS = _RAW[:, PROPERTY_NAMES.index('atomic_radius')]
_IE = _RAW[:, PROPERTY_NAMES.index('ionization_energy')]
_MP = _RAW[:, PROPERTY_NAMES.index('melting_point')]
_VAL = _RAW[:, PROPERTY_NAMES.index('valence')]
_D = _RAW[:, PROPERTY_NAMES.index('d_electrons')]
_F = _RAW[:, PROPERTY_NAMES.index('f_electrons')]
_MASS = _RAW[:, PROPERTY_NAMES.index('mass')]


def compositional_targets(elem_idx: np.ndarray, elem_frac: np.ndarray,
                          elem_mask: np.ndarray) -> np.ndarray:
    """``[B, E]`` composition arrays -> ``[B, 15]`` raw (unnormalized) targets."""
    m = elem_mask.astype(np.float32)
    frac = elem_frac * m
    total = np.clip(frac.sum(axis=1, keepdims=True), 1e-8, None)
    w = frac / total  # normalized weights

    idx = np.clip(elem_idx, 0, 118)

    def gather(tab):
        return tab[idx]

    def wavg(tab):
        return (gather(tab) * w).sum(axis=1)

    n_elements = m.sum(axis=1)
    mw = (gather(_MASS) * frac).sum(axis=1)
    x_h = np.where((idx == 1) & (m > 0), w, 0.0).sum(axis=1)
    z_avg = (idx.astype(np.float32) * w).sum(axis=1)
    z_max = np.where(m > 0, idx, 0).max(axis=1).astype(np.float32)
    en = gather(_EN)
    en_valid = np.where(m > 0, en, np.nan)
    en_avg = wavg(_EN)
    with np.errstate(invalid='ignore'):
        en_diff = np.nan_to_num(np.nanmax(en_valid, axis=1)
                                - np.nanmin(en_valid, axis=1))
    r = gather(_RADIUS)
    r_avg = wavg(_RADIUS)
    r_valid = np.where(m > 0, r, np.nan)
    with np.errstate(invalid='ignore', divide='ignore'):
        r_ratio = np.nan_to_num(np.nanmax(r_valid, axis=1)
                                / np.clip(np.nanmin(r_valid, axis=1), 1e-6, None))
    vec = wavg(_VAL)
    d_frac = np.where((gather(_D) > 0) & (m > 0), w, 0.0).sum(axis=1)
    f_frac = np.where((gather(_F) > 0) & (m > 0), w, 0.0).sum(axis=1)
    ie_avg = wavg(_IE)
    tm_avg = wavg(_MP)
    # size-mismatch delta = sqrt(sum w_i (1 - r_i / r_avg)^2)
    r_avg_safe = np.clip(r_avg, 1e-6, None)[:, None]
    delta = np.sqrt(((1.0 - r / r_avg_safe) ** 2 * w).sum(axis=1))

    return np.stack([
        n_elements, mw, x_h, z_avg, z_max, en_avg, en_diff, r_avg, r_ratio,
        vec, d_frac, f_frac, ie_avg, tm_avg, delta,
    ], axis=1).astype(np.float32)


def normalized_compositional_targets(
    elem_idx, elem_frac, elem_mask,
) -> Tuple[np.ndarray, dict]:
    """Z-scored targets + stats for reproducible inference."""
    raw = compositional_targets(elem_idx, elem_frac, elem_mask)
    mean = raw.mean(axis=0)
    std = raw.std(axis=0) + 1e-8
    return (raw - mean) / std, {'mean': mean.tolist(), 'std': std.tolist()}
