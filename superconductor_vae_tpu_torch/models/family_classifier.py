"""Superconductor family taxonomy and the rule-based classifier (port of
models/family_classifier.py).

``RuleBasedFamilyClassifier`` applies the decision rules to one element
set; ``classify_batch`` labels ``[B, max_elements]`` atomic-number arrays with
the 14-class ``SuperconductorFamily`` by boolean algebra over element
presence, on the host (numpy), as the data pipeline does.  The
``FINE_TO_*`` tables map the 14 classes onto the hierarchical family
head's coarse, cuprate and iron targets.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Set

import numpy as np

from ..chem.elements import SYMBOL_TO_Z


class SuperconductorFamily(enum.IntEnum):
    NOT_SUPERCONDUCTOR = 0
    BCS_CONVENTIONAL = 1
    CUPRATE_YBCO = 2
    CUPRATE_LSCO = 3
    CUPRATE_BSCCO = 4
    CUPRATE_TBCCO = 5
    CUPRATE_HBCCO = 6
    CUPRATE_OTHER = 7
    IRON_PNICTIDE = 8
    IRON_CHALCOGENIDE = 9
    MGB2_TYPE = 10
    HEAVY_FERMION = 11
    ORGANIC = 12
    OTHER_UNKNOWN = 13


N_FAMILIES = 14

# 14-class -> hierarchical label maps (-1: no target at that level)
FINE_TO_COARSE = np.array(
    [-1, 0, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4, 5, 6], dtype=np.int32)
FINE_TO_CUPRATE_SUB = np.array(
    [-1, -1, 0, 1, 2, 3, 4, 5, -1, -1, -1, -1, -1, -1], dtype=np.int32)
FINE_TO_IRON_SUB = np.array(
    [-1, -1, -1, -1, -1, -1, -1, -1, 0, 1, -1, -1, -1, -1], dtype=np.int32)

_HEAVY_FERMION = {'U', 'Ce', 'Yb', 'Pu'}
_ORGANIC = ('C', 'H', 'N', 'S')


class RuleBasedFamilyClassifier:
    """Element-set decision rules for the 14-class family taxonomy."""

    def classify_from_elements(
        self, elements: Set[str],
        fractions: Optional[Dict[str, float]] = None,
    ) -> SuperconductorFamily:
        if {'Cu', 'O'} <= elements:
            if 'Y' in elements and 'Ba' in elements:
                return SuperconductorFamily.CUPRATE_YBCO
            if 'La' in elements and ('Sr' in elements or 'Ba' in elements):
                return SuperconductorFamily.CUPRATE_LSCO
            if 'Bi' in elements and 'Sr' in elements:
                return SuperconductorFamily.CUPRATE_BSCCO
            if 'Tl' in elements and 'Ba' in elements:
                return SuperconductorFamily.CUPRATE_TBCCO
            if 'Hg' in elements and 'Ba' in elements:
                return SuperconductorFamily.CUPRATE_HBCCO
            return SuperconductorFamily.CUPRATE_OTHER
        if 'Fe' in elements:
            if 'As' in elements or 'P' in elements:
                return SuperconductorFamily.IRON_PNICTIDE
            if 'Se' in elements or 'Te' in elements:
                return SuperconductorFamily.IRON_CHALCOGENIDE
        if 'Mg' in elements and 'B' in elements:
            return SuperconductorFamily.MGB2_TYPE
        if elements & _HEAVY_FERMION:
            return SuperconductorFamily.HEAVY_FERMION
        if 'C' in elements and len(elements & set(_ORGANIC)) / max(len(elements), 1) > 0.5:
            return SuperconductorFamily.ORGANIC
        if len(elements) <= 4:
            return SuperconductorFamily.BCS_CONVENTIONAL
        return SuperconductorFamily.OTHER_UNKNOWN


def classify_batch(element_indices: np.ndarray,
                   element_mask: np.ndarray) -> np.ndarray:
    """[B, E] atomic numbers and slot mask -> [B] int32 family ids.

    Assumes every row is a superconductor; the caller sets non-SC rows to
    ``NOT_SUPERCONDUCTOR``.  Later rules override earlier ones, so the
    cuprate sub-families win over everything else."""
    element_indices = np.asarray(element_indices)
    element_mask = np.asarray(element_mask, bool)
    b = element_indices.shape[0]

    def has(sym):
        return ((element_indices == SYMBOL_TO_Z[sym]) & element_mask).any(axis=1)

    F = SuperconductorFamily
    n_elem = element_mask.sum(axis=1)
    cuprate = has('Cu') & has('O')
    fe = has('Fe')

    out = np.full(b, int(F.OTHER_UNKNOWN), dtype=np.int32)
    out = np.where(n_elem <= 4, int(F.BCS_CONVENTIONAL), out)
    # organic: C present and > 50% of the distinct elements in {C, H, N, S}
    organic_count = sum(has(s).astype(np.int32) for s in _ORGANIC)
    out = np.where(has('C') & (organic_count * 2 > n_elem), int(F.ORGANIC), out)
    out = np.where(has('U') | has('Ce') | has('Yb') | has('Pu'),
                   int(F.HEAVY_FERMION), out)
    out = np.where(has('Mg') & has('B'), int(F.MGB2_TYPE), out)
    out = np.where(fe & (has('Se') | has('Te')), int(F.IRON_CHALCOGENIDE), out)
    out = np.where(fe & (has('As') | has('P')), int(F.IRON_PNICTIDE), out)
    out = np.where(cuprate, int(F.CUPRATE_OTHER), out)
    out = np.where(cuprate & has('Hg') & has('Ba'), int(F.CUPRATE_HBCCO), out)
    out = np.where(cuprate & has('Tl') & has('Ba'), int(F.CUPRATE_TBCCO), out)
    out = np.where(cuprate & has('Bi') & has('Sr'), int(F.CUPRATE_BSCCO), out)
    out = np.where(cuprate & has('La') & (has('Sr') | has('Ba')),
                   int(F.CUPRATE_LSCO), out)
    out = np.where(cuprate & has('Y') & has('Ba'), int(F.CUPRATE_YBCO), out)
    return out.astype(np.int32)
