"""Synthetic formula dataset for tests and benchmarks (port of
data/synthetic.py).

Plausible multi-element formulas with integer and fraction subscripts,
fake Magpie features derived from the composition, and a Tc drawn for the
superconductors; ``bench.py`` trains on it.  Drawn from
``np.random.default_rng(seed)`` in the JAX package's order, so both give
the same arrays for a seed.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.family_classifier import RuleBasedFamilyClassifier
from ..tokenizer import default_tokenizer
from .compositional_targets import normalized_compositional_targets
from .pipeline import (MAX_ELEMENTS, DatasetArrays, NormStats, composition_slots,
                       parse_formula_composition)

_COMMON = ['Y', 'Ba', 'Cu', 'O', 'La', 'Sr', 'Fe', 'As', 'Se', 'Mg', 'B',
           'Bi', 'Ca', 'Tl', 'Hg', 'Nb', 'Sn', 'Al', 'Ti', 'H', 'S', 'K']
_FRACTIONS = ['1/2', '1/4', '3/4', '1/5', '2/5', '3/5', '4/5', '17/20',
              '3/20', '1/10', '9/10', '1/20']


def _random_formula(rng: np.random.Generator) -> str:
    n_elem = int(rng.integers(1, 6))
    elems = rng.choice(len(_COMMON), size=n_elem, replace=False)
    parts = []
    for e in elems:
        sym = _COMMON[int(e)]
        kind = rng.random()
        if kind < 0.4:
            parts.append(f'{sym}{int(rng.integers(1, 10))}')
        elif kind < 0.7:
            parts.append(f'{sym}({_FRACTIONS[int(rng.integers(len(_FRACTIONS)))]})')
        else:
            parts.append(sym)
    return ''.join(parts)


def synthetic_dataset(n: int = 256, max_len: int = 30, magpie_dim: int = 145,
                      seed: int = 0) -> DatasetArrays:
    rng = np.random.default_rng(seed)
    tokenizer = default_tokenizer(max_len=max_len)
    formulas: List[str] = [_random_formula(rng) for _ in range(n)]

    tokens = tokenizer.encode_batch(formulas)
    elem_idx, elem_frac, elem_mask = composition_slots(formulas)
    classifier = RuleBasedFamilyClassifier()
    is_sc = rng.integers(0, 2, n).astype(np.int32)
    family = np.array([
        int(classifier.classify_from_elements(set(parse_formula_composition(f)))) if sc else 0
        for f, sc in zip(formulas, is_sc)], np.int32)

    tc_k = np.where(is_sc == 1, rng.gamma(2.0, 15.0, n), 0.0)
    tc_log = np.log1p(tc_k)
    sc_rows = is_sc == 1
    tc_mean = float(tc_log[sc_rows].mean()) if sc_rows.any() else 0.0
    tc_std = float(tc_log[sc_rows].std() + 1e-8) if sc_rows.any() else 1.0
    tc = ((tc_log - tc_mean) / tc_std).astype(np.float32)

    # deterministic fake Magpie: random projection of composition + noise
    proj = np.random.default_rng(7).normal(0, 1, (MAX_ELEMENTS * 2, magpie_dim))
    feats = np.concatenate([elem_idx / 118.0, elem_frac], axis=1) @ proj
    magpie = (feats + rng.normal(0, 0.1, feats.shape)).astype(np.float32)
    magpie = (magpie - magpie.mean(0)) / (magpie.std(0) + 1e-8)

    comp_targets, comp_stats = normalized_compositional_targets(
        elem_idx, elem_frac, elem_mask)

    hp = (rng.random(n) < 0.02).astype(np.float32) * (is_sc == 1)
    label = np.where(is_sc == 1, family % 8, 8).astype(np.int32)

    return DatasetArrays(
        formulas=formulas, tokens=tokens,
        element_indices=elem_idx, element_fractions=elem_frac,
        element_mask=elem_mask, tc=tc, magpie=magpie, is_sc=is_sc,
        label=label, hp=hp, family=family, comp_targets=comp_targets,
        norm_stats=NormStats(
            tc_mean=tc_mean, tc_std=tc_std, tc_log_transform=True,
            magpie_mean=np.zeros(magpie_dim, np.float32),
            magpie_std=np.ones(magpie_dim, np.float32),
            magpie_skewed_indices=[], magpie_sc_only_norm=True,
            comp_target_stats=comp_stats,
        ),
    )
