"""Source-specific dataset readers for corpus construction (port of
data/ingest_sources.py).

Per-source readers of the reference's ingestion suite — NEMAD
(reference: scripts/ingest_nemad.py), the multi-source merger over MDR
SuperCon / SuperCon2 / 3DSC / SODNet / manual hydrides (reference:
scripts/ingest_new_datasets.py) — that all emit one normalized schema:

    formula (raw cleaned string), Tc (K), is_superconductor,
    tc_source ('experimental'|'calculated'), dataset, category_hint

The JAX package's readers return pandas frames; pandas is not on the
card's machine, so these read their files with the data pipeline's
standard-library reader (``read_csv``'s semantics: numeric columns
parsed as float64, missing cells NaN, bad lines skipped) and return a
list of rows, one dict each, with the same values in the same order
(``rows_as_columns`` turns them into columns).  ``scripts/ingest.py``
drives them.  No network access: readers take local files only.
"""

from __future__ import annotations

import math
import re
import unicodedata
from fractions import Fraction
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set

import numpy as np

__all__ = [
    'parse_tc_text', 'clean_formula_text', 'is_retracted_or_contaminated',
    'read_nemad', 'read_mdr', 'read_supercon2', 'read_threedsc',
    'read_sodnet', 'manual_hydrides', 'merge_sources',
    'canonical_key', 'rows_as_columns',
]

# ---------------------------------------------------------------------------
# Tc free-text parsing (NEMAD's Superconducting_Transition_Temperature field)
# ---------------------------------------------------------------------------

# qualitative / conditional descriptions that carry no single reliable value
_TC_SKIP_SUBSTRINGS = (
    'onset', 'midpoint', 'zero resistance', 'annealed', 'as-prepared',
    'as-synthesized', 'cooling', 'kbar', 'gpa', 'pressure', 'calculated',
    'resistivity', 'suscept', 'specific heat', 'irrad', 'sample #',
    'figure', 'crystal', 'thickness', 'film', 'tc1', 'tc2', 'tc,', 'tc(',
    'tc^', 'tc+', 'tc-', 'tconset', 'tczero', 'o16', 'o18',
)
_TC_SKIP_PREFIXES = (
    'nsc', 'no supercond', 'not supercond', 'not observed', 'no transition',
    'variable', 'varies', 'suppressed', 'depress', 'decreas', 'enhanc',
    'above', 'below', 'between', 'broad', 'anomal', 'near', 'trace',
    'room temp', 'behaves', 'shows', 'detected', 'increas', 'rises',
    'peak', 'plateau', 'maximum', 'minimum', 'filamentary', 'abrupt',
    'rapidly', 'strongly', 'lower', 'local', 'pressure-induced',
    'proximity-induced', 'pair-breaking', 'sc under', 'superconducting above',
)
_NUM = r'(\d+(?:\.\d+)?)'


def parse_tc_text(text) -> Optional[float]:
    """Free-text Tc -> Kelvin float, or None when no single reliable value.

    Handles the notation zoo of literature-scraped fields: ``"93 K"``,
    ``"~39K"``, ``"4.2"``, ranges (midpoint), ``"92 ± 1 K"`` (center).
    Qualitative, conditional (pressure/annealing/onset-vs-zero),
    multi-valued, sub-Kelvin-unit and inequality entries return None —
    a wrong Tc is worse than a dropped row
    (reference behavior: scripts/ingest_nemad.py:93-196).
    """
    if not isinstance(text, str):
        return None
    s = text.strip()
    low = s.lower()
    if not s or low in ('nsc', 'n/a', 'na', '-', 'n.s.', 'n.s', 'none'):
        return None
    if any(low.startswith(p) for p in _TC_SKIP_PREFIXES):
        return None
    if any(k in low for k in _TC_SKIP_SUBSTRINGS):
        return None
    if re.search(r'\d\s*(mk|mev|µev|uev)\b', low):
        return None
    # multi-valued entries: "90 K, 60 K" / "90; 60" / "90/110 K"
    if ';' in s or (',' in s and 'k' in low) or ('/' in s and 'k' in low):
        return None
    # inequalities are bounds, not values
    if re.match(r'^\s*[≃≲≳≤≥<>]', s):
        return None
    s = s.replace('∼', '~').replace('≈', '~').replace('–', '-') \
         .replace('—', '-')
    m = re.match(rf'^~?{_NUM}\s*(?:±\s*{_NUM})?\s*K?$', s)
    if m:
        return float(m.group(1))
    m = re.match(rf'^~?{_NUM}\s*-\s*{_NUM}\s*K?$', s)
    if m:
        lo, hi = float(m.group(1)), float(m.group(2))
        return (lo + hi) / 2.0 if lo <= hi else None
    return None


# ---------------------------------------------------------------------------
# Formula cleaning (literature notation -> parseable composition string)
# ---------------------------------------------------------------------------

_SUBSUP = str.maketrans('₀₁₂₃₄₅₆₇₈₉⁰¹²³⁴⁵⁶⁷⁸⁹', '01234567890123456789')


def clean_formula_text(raw) -> Optional[str]:
    """Literature formula string -> cleaned ASCII formula, or None.

    Normalizes unicode sub/superscripts, strips variable-stoichiometry
    notation (±δ, +x, O7-y), dopant suffixes ("+ 2 wt% Ag"), picks the
    base phase of additive/base slash composites, and rejects strings
    with no recoverable stoichiometry (pure dash alloys "Nb-Ti",
    percentage mixtures) — reference: scripts/ingest_nemad.py:264-346.
    """
    if not isinstance(raw, str) or not raw.strip():
        return None
    s = unicodedata.normalize('NFKC', raw.strip()).translate(_SUBSUP)
    s = s.replace('·', '').replace('•', '')
    s = s.replace('–', '-').replace('—', '-')
    s = s.replace('​', '').replace(' ', ' ')
    # variable stoichiometry: ±δ / +δ / -δ / +x / -y / ±0.1
    s = re.sub(r'[±+\-]?\s*[δΔ]', '', s)
    s = re.sub(r'[+\-]\s*[xyzn]\b', '', s)
    s = re.sub(r'±\s*\d*\.?\d*', '', s)
    # dopant additions: "+ 2 wt% Ag", "with 5% excess O"
    s = re.sub(r'\+\s*[\d.]+\s*(wt|at|mol|vol)\s*%.*$', '', s, flags=re.I)
    s = re.sub(r'\bwith\s+[\d.]+\s*%.*$', '', s, flags=re.I)
    # additive/base composites: "(Ag)0.5/YBa2Cu3O7" -> base phase.
    # A slash inside parentheses is (p/q) fraction notation — the
    # tokenizer's own stoichiometry format — NOT a composite separator.
    composite_slash = re.search(r'/(?![^()]*\))', s) if '/' in s else None
    if composite_slash:
        left, right = s[:composite_slash.start()], s[composite_slash.end():]
        if re.match(r'^\([A-Za-z0-9]+\)\s*[\d.]+$', left.strip()):
            s = right.strip()
        else:
            s = left.strip()
    if re.search(r'\d+\s*%', s):
        return None
    # dash alloys with no stoichiometry: "Nb-Ti", "La-Ba-Cu-O"
    if re.match(r'^([A-Z][a-z]?\s*-\s*)+[A-Z][a-z]?$', s):
        return None
    s = re.sub(r'[{}]', '', s)
    # trailing prose comments "(single phase)"
    s = re.sub(r'\s*\([a-z ]+\)\s*$', '', s, flags=re.I)
    s = s.strip()
    if len(s) < 2 or not re.search(r'[A-Z]', s):
        return None
    return s


# ---------------------------------------------------------------------------
# Retraction / contamination filters
# ---------------------------------------------------------------------------

def is_retracted_or_contaminated(formula: str, tc: float,
                                 elements: Optional[Set[str]] = None,
                                 n_elements: Optional[int] = None) -> bool:
    """True for rows that are known-retracted claims or likely non-SC
    transitions mislabeled as Tc (reference:
    scripts/ingest_new_datasets.py read_mdr/read_supercon2 filters):

    - Lu-H near-room-temperature (250-300K) and C-S-H (280-295K)
      retracted claims; Pb-C-O >300K unconfirmed,
    - manganite Curie temperatures ((La|Ca|Sr)-Mn-O with "Tc">50K),
    - dilute-magnetic ZnO "Tc">50K,
    - any non-hydride >200K (structural/magnetic transitions).
    """
    if elements is None:
        elements = set(re.findall(r'[A-Z][a-z]?', formula))
    if n_elements is None:
        n_elements = len(elements)
    has_h = 'H' in elements
    if has_h and 'Lu' in elements and 250 <= tc <= 300:
        return True
    if {'C', 'S', 'H'} <= elements and n_elements <= 4 and 280 <= tc <= 295:
        return True
    if {'Pb', 'C', 'O'} <= elements and tc > 300:
        return True
    if 'Mn' in elements and 'O' in elements and tc > 50 and \
            elements & {'La', 'Ca', 'Sr'}:
        return True
    if {'Zn', 'O'} <= elements and n_elements <= 3 and tc > 50:
        return True
    if tc > 200 and not has_h:
        return True
    return False


# ---------------------------------------------------------------------------
# Per-source readers -> normalized rows
# ---------------------------------------------------------------------------

_SCHEMA = ['formula', 'Tc', 'is_superconductor', 'tc_source', 'dataset',
           'category_hint']
Row = Dict[str, object]


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _to_number(v) -> float:
    """``pd.to_numeric(errors='coerce')`` of one cell."""
    if _missing(v):
        return math.nan
    try:
        return float(v)
    except (TypeError, ValueError):
        return math.nan


def _read(path, **kw) -> Dict[object, np.ndarray]:
    from .pipeline import _read_csv_columns
    return _read_csv_columns(path, bad_lines='skip', **kw)


def _hints(cols: Mapping, name: str, n: int) -> List[object]:
    """The category-hint column (``fillna('')``), or '' on every row."""
    if name not in cols:
        return [''] * n
    return ['' if _missing(v) else v for v in cols[name]]


def _finish(formulas: Sequence, tcs: Sequence, dataset: str,
            tc_source: str = 'experimental', tc_max: float = 400.0,
            drop_retracted: bool = True, hints: Optional[Sequence] = None) -> List[Row]:
    """Common tail: Tc range filter, retraction filter, schema projection."""
    hints = [''] * len(formulas) if hints is None else hints
    out = []
    for f, tc, hint in zip(formulas, tcs, hints):
        if _missing(f):
            continue
        tc = _to_number(tc)
        if not (math.isfinite(tc) and 0 <= tc <= tc_max):
            continue
        if drop_retracted and is_retracted_or_contaminated(f, tc):
            continue
        out.append({'formula': f, 'Tc': tc, 'is_superconductor': int(tc > 0),
                    'tc_source': tc_source, 'dataset': dataset, 'category_hint': hint})
    return out


def rows_as_columns(rows: Sequence[Row]) -> Dict[str, list]:
    """Rows -> {column: values}, the columns in order of first appearance,
    a row's missing column NaN (as ``pd.DataFrame(rows)``)."""
    names: List[str] = []
    for r in rows:
        names += [k for k in r if k not in names]
    return {k: [r.get(k, math.nan) for r in rows] for k in names}


def read_nemad(path_or_columns, experimental_only: bool = True) -> List[Row]:
    """NEMAD export: Chemical_Composition + Median_Tc_By_Composition_K
    (primary) with free-text Tc fallback; experimental-rows filter.  Takes
    a CSV path or a mapping of columns.
    Reference: scripts/ingest_nemad.py:77-260."""
    cols = (_read(path_or_columns) if isinstance(path_or_columns, (str, Path))
            else {k: list(v) for k, v in path_or_columns.items()})
    n = len(next(iter(cols.values()))) if cols else 0
    keep = list(range(n))
    if experimental_only and 'Data_Type' in cols:
        keep = [i for i in keep if 'experiment' in str(cols['Data_Type'][i]).lower()]

    def _tc(i):
        med = cols['Median_Tc_By_Composition_K'][i] if 'Median_Tc_By_Composition_K' in cols \
            else None
        try:
            v = float(med)
            if v >= 0 and v == v:  # finite, non-NaN
                return v
        except (TypeError, ValueError):
            pass
        text = cols.get('Superconducting_Transition_Temperature')
        return parse_tc_text(text[i] if text is not None else None)

    formulas = cols['Chemical_Composition'] if 'Chemical_Composition' in cols \
        else cols.get('formula')
    tcs = [_tc(i) for i in keep]
    return _finish([clean_formula_text(formulas[i]) for i in keep],
                   [math.nan if t is None else t for t in tcs], 'nemad')


def read_mdr(path) -> List[Row]:
    """MDR SuperCon (NIMS) primary.tsv: 3 header rows; positional columns
    (2=formula, 5=Tc); variable-oxygen suffix strip.
    Reference: scripts/ingest_new_datasets.py:97-175."""
    def _clean(raw):
        if not isinstance(raw, str) or not raw.strip():
            return None
        s = re.sub(r'[-+][YZXdyzx]$', '', raw.strip())
        s = re.sub(r'O[zZxXyYdD]$', 'O', s)
        return s or None

    cols = _read(path, sep='\t', skiprows=3, header=False, typed=False)
    return _finish([_clean(f) for f in cols[2]], cols[5], 'mdr_supercon')


def read_supercon2(path) -> List[Row]:
    """SuperCon2 (literature-mined) cleanup CSV: formula +
    criticalTemperature, contamination filters via ``_finish``.
    Reference: scripts/ingest_new_datasets.py:178-249."""
    cols = _read(path)
    n = len(cols['formula'])
    return _finish([clean_formula_text(f) for f in cols['formula']],
                   cols['criticalTemperature'] if 'criticalTemperature' in cols
                   else cols['Tc'], 'supercon2', hints=_hints(cols, 'materialClass', n))


def read_threedsc(path) -> List[Row]:
    """3DSC_MP.csv (comment header line): formula_sc + tc + sc_class hint.
    Reference: scripts/ingest_new_datasets.py:252-283."""
    cols = _read(path, comment='#')
    n = len(cols['formula_sc'])
    return _finish(list(cols['formula_sc']), cols['tc'], '3dsc', drop_retracted=False,
                   hints=_hints(cols, 'sc_class', n))


def read_sodnet(path) -> List[Row]:
    """SODNet SuperCon CSV: Formula + Tc + Materials_family hint.
    Reference: scripts/ingest_new_datasets.py:285-313."""
    cols = _read(path)
    n = len(cols['Formula'])
    return _finish(list(cols['Formula']), cols['Tc'], 'sodnet', drop_retracted=False,
                   hints=_hints(cols, 'Materials_family', n))


# 12 DAC-synthesized hydrides from the experimental literature — the high-Tc
# tail the scraped databases under-represent (reference:
# scripts/ingest_new_datasets.py:315-358; docs/high_tc_data_acquisition.md).
_MANUAL_HYDRIDES = (
    ('H3S', 203.0, 155), ('LaH10', 250.0, 170), ('LaH10', 260.0, 190),
    ('YH9', 243.0, 201), ('YH6', 224.0, 166), ('CaH6', 215.0, 172),
    ('La0.5Y0.5H10', 253.0, 183), ('La0.5Ce0.5H9', 178.0, 97),
    ('ThH10', 161.0, 175), ('ThH9', 146.0, 170), ('CeH9', 117.0, 95),
    ('LaBeH8', 110.0, 80),
)


def manual_hydrides() -> List[Row]:
    """The curated experimental hydride entries (all high-pressure SC)."""
    return [{'formula': f, 'Tc': tc, 'is_superconductor': 1,
             'tc_source': 'experimental', 'dataset': 'manual_hydrides',
             'category_hint': 'hydride', 'pressure_gpa': p}
            for f, tc, p in _MANUAL_HYDRIDES]


# ---------------------------------------------------------------------------
# Merge with dedup / conflict resolution / holdout exclusion
# ---------------------------------------------------------------------------

def canonical_key(formula: str) -> Optional[str]:
    """Order/scale-invariant composition key for cross-source dedup:
    elements sorted, fractions normalized to sum 1 and rationalized.
    The same physical composition spelled differently by two databases
    ("YBa2Cu3O7" vs "Ba2Cu3O7Y1") maps to one key."""
    from .pipeline import parse_formula_composition
    comp = parse_formula_composition(formula)
    if not comp:
        return None
    total = sum(comp.values())
    if total <= 0:
        return None
    parts = []
    for el in sorted(comp):
        frac = Fraction(comp[el] / total).limit_denominator(10000)
        parts.append(f'{el}:{frac.numerator}/{frac.denominator}')
    return '|'.join(parts)


_SOURCE_PRIORITY = {  # higher wins a Tc conflict for the same composition
    'manual_hydrides': 5, 'mdr_supercon': 4, 'nemad': 3, '3dsc': 2,
    'sodnet': 2, 'supercon2': 1,
}


def merge_sources(frames: Iterable[Sequence[Row]], holdout_keys: Set[str] = frozenset(),
                  existing_keys: Set[str] = frozenset(), tc_tol_frac: float = 0.2):
    """Concatenate normalized rows, resolve per-composition conflicts and
    drop holdout/already-ingested compositions.

    Same composition across sources: if the Tc spread is within
    ``tc_tol_frac`` of the median, keep the median-Tc row (robust vs a
    straight priority pick); otherwise keep the highest-priority source's
    row (curated > NIMS > scraped — reference:
    scripts/ingest_new_datasets.py merge step).  Every row carries every
    column of any frame (NaN where its own frame lacks it).  Returns
    (merged rows, report dict).
    """
    cols = rows_as_columns([r for f in frames for r in f])
    n = len(cols.get('formula', []))
    rows = [{k: v[i] for k, v in cols.items()} for i in range(n)]
    keys = [canonical_key(r['formula']) for r in rows]
    report: Dict[str, int] = {'input': len(rows)}
    idx = [i for i in range(n) if keys[i] is not None]
    report['parseable'] = len(idx)
    idx = [i for i in idx if keys[i] not in holdout_keys]
    report['after_holdout_exclusion'] = len(idx)
    idx = [i for i in idx if keys[i] not in existing_keys]
    report['after_existing_exclusion'] = len(idx)

    groups: Dict[str, List[int]] = {}
    for i in idx:
        groups.setdefault(keys[i], []).append(i)
    keep = []
    for grp in groups.values():
        if len(grp) == 1:
            keep.append(grp[0])
            continue
        tcs = np.array([rows[i]['Tc'] for i in grp], float)
        med = float(np.median(tcs))
        spread = float(tcs.max() - tcs.min())
        if spread <= tc_tol_frac * max(med, 1.0):
            keep.append(grp[int(np.argsort(tcs)[len(tcs) // 2])])
        else:
            pri = np.array([_SOURCE_PRIORITY.get(rows[i]['dataset'], 0) for i in grp])
            keep.append(grp[int(np.argmax(pri))])
    out = [rows[i] for i in keep]
    report['merged'] = len(out)
    report['conflicts_resolved'] = report['after_existing_exclusion'] - len(out)
    return out, report


def load_holdout_keys(json_path) -> Set[str]:
    """Canonical keys of the generative holdout set (never train on them)."""
    import json
    with open(json_path) as f:
        data = json.load(f)
    formulas = (data.get('holdout_formulas') or data.get('formulas')
                or [e.get('formula') for e in data.get('holdout_samples', [])
                    if isinstance(e, dict)])
    keys = {canonical_key(f) for f in formulas if f}
    keys.discard(None)
    return keys
