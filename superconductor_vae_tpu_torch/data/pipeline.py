"""Host-side data pieces of data/pipeline.py that the inference and
training paths need.

``parse_formula_composition`` and ``composition_slots`` turn formulas into
the encoder's element slots, as ``load_dataset`` does; ``category_to_label``
gives a row's contrastive category label.  ``read_csv_rows`` reads the
first rows of a corpus CSV with the standard library alone (``gzip`` +
``csv``), for machines without pandas.  ``NormStats`` and the rest of
``load_dataset`` come with the data slice.
"""

from __future__ import annotations

import csv
import gzip
import math
import re
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from ..chem.elements import SYMBOL_TO_Z

MAX_ELEMENTS = 12

# Contrastive category labels
SC_CATEGORY_LABELS = {
    'Cuprates': 0, 'Iron-based': 1, 'Bismuthates': 2, 'Borocarbides': 3,
    'Elemental Superconductors': 4, 'Hydrogen-rich Superconductors': 5,
    'Organic Superconductors': 6, 'Other': 7,
    'Non-SC: Materials Project': 8, 'Non-SC: Magnetic': 9,
    'Non-SC: Thermoelectric': 10, 'Non-SC: Anisotropy': 11,
    'High-pressure (non-hydride)': 12,
}

# columns of the corpus CSVs that are not Magpie features (the JAX loader
# drops these and every non-numeric column, e.g. ``source``)
NON_FEATURE_COLUMNS = frozenset({
    'formula', 'Tc', 'composition', 'category', 'is_superconductor',
    'compound possible', 'formula_original', 'requires_high_pressure',
    'source'})

def category_to_label(category: str, use_extended: bool = True,
                      requires_high_pressure: int = 0) -> int:
    """A CSV ``category`` as its contrastive label: high-pressure SC rows
    (other than hydrides) get their own label, unknown non-SC categories
    the last label, other unknown categories 'Other'."""
    if not use_extended:
        return 1 if str(category).startswith('Non-SC') else 0
    category = str(category)
    if (requires_high_pressure == 1
            and category != 'Hydrogen-rich Superconductors'
            and not category.startswith('Non-SC')):
        return SC_CATEGORY_LABELS['High-pressure (non-hydride)']
    if category in SC_CATEGORY_LABELS:
        return SC_CATEGORY_LABELS[category]
    if category.startswith('Non-SC'):
        return max(SC_CATEGORY_LABELS.values())
    return SC_CATEGORY_LABELS['Other']


_COMP_SCAN = re.compile(
    r'(?:\{(?P<mass>\d+)\})?(?P<el>[A-Z][a-z]?)'
    r'(?:\((?P<num>\d+)/(?P<den>\d+)\)|(?P<dec>\d*\.\d+)|(?P<int>\d+))?'
)


def parse_formula_composition(formula: str) -> Dict[str, float]:
    """Formula string -> {element: amount}. Isotopes fold into parent element.

    Amounts repeated for the same element accumulate (crystallographic sites).
    """
    comp: Dict[str, float] = {}
    for m in _COMP_SCAN.finditer(formula):
        el = m.group('el')
        if not el or el not in SYMBOL_TO_Z:
            continue
        qty = 1.0
        if m.group('num') is not None:
            den = int(m.group('den'))
            qty = int(m.group('num')) / den if den else 1.0
        elif m.group('dec') is not None:
            qty = float(m.group('dec'))
        elif m.group('int') is not None:
            qty = float(int(m.group('int')))
        comp[el] = comp.get(el, 0.0) + qty
    return comp


def composition_slots(formulas: Sequence[str]):
    """Formulas -> (element_indices int32, element_fractions float32,
    element_mask bool), each [N, 12]: atomic numbers in order of first
    appearance, molar fractions, and the occupied slots."""
    n = len(formulas)
    idx = np.zeros((n, MAX_ELEMENTS), np.int32)
    frac = np.zeros((n, MAX_ELEMENTS), np.float32)
    mask = np.zeros((n, MAX_ELEMENTS), bool)
    for i, f in enumerate(formulas):
        comp = parse_formula_composition(f)
        total = sum(comp.values()) or 1.0
        for j, (el, amt) in enumerate(list(comp.items())[:MAX_ELEMENTS]):
            idx[i, j] = SYMBOL_TO_Z[el]
            frac[i, j] = amt / total
            mask[i, j] = True
    return idx, frac, mask


def _float(s: str) -> float:
    return float(s) if s.strip() else math.nan


def read_csv_rows(path: str | Path, n_rows: int) -> Dict[str, object]:
    """The first ``n_rows`` rows of a corpus CSV (``.csv`` or ``.csv.gz``).

    Returns ``formula`` (list of str), ``tc`` (float64 [N], Kelvin, empty =
    0), ``is_sc`` (int32 [N]), ``hp`` (float32 [N],
    ``requires_high_pressure``, 0 where absent), ``category`` (list of str,
    '' where absent), ``magpie`` (float32 [N, F]: every column outside
    ``NON_FEATURE_COLUMNS``, in file order, empty = NaN) and
    ``magpie_columns``."""
    path = Path(path)
    opener = gzip.open if path.suffix == '.gz' else open
    with opener(path, 'rt', newline='') as fh:
        reader = csv.reader(fh)
        header = next(reader)
        col = {name: i for i, name in enumerate(header)}
        feat = [i for i, name in enumerate(header)
                if name not in NON_FEATURE_COLUMNS]
        formulas: List[str] = []
        tc, is_sc, hp, category, magpie = [], [], [], [], []
        for row in reader:
            if len(formulas) == n_rows:
                break
            formulas.append(row[col['formula']])
            tc_s = row[col['Tc']]
            tc.append(float(tc_s) if tc_s.strip() else 0.0)
            is_sc.append(int(float(row[col['is_superconductor']]))
                         if 'is_superconductor' in col else 1)
            hp.append(float(row[col['requires_high_pressure']] or 0.0)
                      if 'requires_high_pressure' in col else 0.0)
            category.append(row[col['category']] if 'category' in col else '')
            magpie.append([_float(row[i]) for i in feat])
    return {
        'formula': formulas,
        'tc': np.asarray(tc, np.float64),
        'is_sc': np.asarray(is_sc, np.int32),
        'hp': np.asarray(hp, np.float32),
        'category': category,
        'magpie': np.asarray(magpie, np.float32).reshape(len(formulas), len(feat)),
        'magpie_columns': [header[i] for i in feat],
    }
