"""Multi-source dataset ingestion -> one processed training CSV (port of
scripts/ingest.py).

Reads raw source CSVs/TSVs, normalizes formula + Tc columns, dedups by
(formula, rounded Tc), merges non-SC negatives (Materials Project, or its
fallback lists offline), applies the high-pressure labeling heuristics,
and writes a single contrastive training CSV (reference:
scripts/ingest_jarvis.py, ingest_nemad.py, ingest_new_datasets.py,
ingest_non_sc.py, label_high_pressure.py).  The JAX script works on
pandas frames; this one reads with the data pipeline's standard-library
reader and writes the same CSV, row for row and cell for cell, as
pandas' ``to_csv`` writes it.

Usage:
    python -m superconductor_vae_tpu_torch.scripts.ingest \\
        --sources a.csv b.csv --out data/processed/train.csv
"""

from __future__ import annotations

import argparse
import csv
import math
import re
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

FORMULA_COLS = ('formula', 'formula_pretty', 'composition', 'name',
                'chemical formula')
TC_COLS = ('Tc', 'tc', 'Tc (K)', 'critical_temperature', 'Tc_exp',
           'Tc (of this sample) recommended')

# SuperCon deficiency notation: "O4-Y"/"O3+X" mean O_{4-y}; keep the stated
# stoichiometry and drop the variable suffix
_DEFICIENCY_SUFFIX = re.compile(r'([+-][XYZ])+$', re.IGNORECASE)
ROOT = Path(__file__).resolve().parents[2]


def to_fraction_notation(formula: str) -> str:
    """Decimal formula -> the tokenizer's (p/q) fraction notation: elements
    sorted, amounts via Fraction(amt).limit_denominator(1000), integers
    bare, fractions as El(p/q) (reference: scripts/ingest_jarvis.py:437-449)."""
    from superconductor_vae_tpu_torch.data import parse_formula_composition
    comp = parse_formula_composition(formula)
    if not comp:
        return formula
    parts = []
    for el, amt in sorted(comp.items()):
        frac = Fraction(amt).limit_denominator(1000)
        if frac.denominator == 1:
            parts.append(el if frac.numerator == 1 else f'{el}{frac.numerator}')
        else:
            parts.append(f'{el}({frac})')
    return ''.join(parts)


def is_high_pressure(formula: str, tc: float) -> int:
    """The high-pressure label (reference: scripts/label_high_pressure.py)."""
    from superconductor_vae_tpu_torch.data import parse_formula_composition
    comp = parse_formula_composition(formula)
    total = sum(comp.values()) or 1.0
    h_frac = comp.get('H', 0.0) / total
    # hydrogen-dominated high-Tc compounds are DAC-synthesized hydrides
    if h_frac > 0.5 and tc > 77:
        return 1
    # elemental HP superconductors (e.g., Ca, S, Se at megabar pressures)
    if len(comp) == 1 and tc > 10 and next(iter(comp)) in (
            'Ca', 'S', 'Se', 'P', 'B', 'Li', 'Y'):
        return 1
    return 0


def _read(path, **kw):
    from superconductor_vae_tpu_torch.data.pipeline import _read_csv_columns
    return _read_csv_columns(path, **kw)


def _str(v) -> str:
    """``astype(str)`` of one cell (NaN -> 'nan', 92.0 -> '92.0')."""
    return 'nan' if isinstance(v, float) and math.isnan(v) else str(v)


def _number(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return math.nan


def load_source(path: Path) -> Optional[List[Dict]]:
    """One generic source: its formula and Tc columns found by name."""
    if path.suffix == '.tsv':
        # SuperCon-style TSVs carry a column-index line above the header
        cols = _read(path, sep='\t')
        if not any(c in cols for c in FORMULA_COLS + TC_COLS):
            cols = _read(path, sep='\t', skiprows=1)
    else:
        cols = _read(path)
    fcol = next((c for c in FORMULA_COLS if c in cols), None)
    tcol = next((c for c in TC_COLS if c in cols), None)
    if fcol is None:
        print(f'  skip {path.name}: no formula column')
        return None
    n = len(cols[fcol])
    tcs = [_number(v) for v in cols[tcol]] if tcol else [0.0] * n
    out = []
    for f, tc in zip(cols[fcol], tcs):
        f = _DEFICIENCY_SUFFIX.sub('', _str(f).strip())
        if f:
            out.append({'formula': f, 'Tc': float(np.clip(np.nan_to_num(tc), 0, 400)),
                        'source': path.stem})
    return out


def _cell(v) -> str:
    """A cell as pandas' ``to_csv`` writes it: NaN empty, numpy float32 in
    its shortest float32 form, floats by ``repr``."""
    if isinstance(v, np.floating):
        return '' if np.isnan(v) else str(v)
    if isinstance(v, float):
        return '' if math.isnan(v) else repr(v)
    return str(v)


def write_csv(path: Path, rows: List[Dict]) -> None:
    from superconductor_vae_tpu_torch.data.ingest_sources import rows_as_columns
    cols = rows_as_columns(rows)
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(list(cols))
        for i in range(len(rows)):
            w.writerow([_cell(v[i]) for v in cols.values()])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--sources', nargs='+', default=[],
                   help='generic CSV/TSV sources (column auto-detection)')
    p.add_argument('--out', required=True)
    # source-specific readers (data/ingest_sources.py), each on a local
    # file in that source's native export format
    p.add_argument('--nemad', default=None,
                   help='NEMAD superconductor CSV (Chemical_Composition + '
                        'Median_Tc/free-text Tc; experimental rows only)')
    p.add_argument('--mdr', default=None, help='MDR SuperCon (NIMS) primary.tsv')
    p.add_argument('--supercon2', default=None,
                   help='SuperCon2 literature-mined cleanup CSV')
    p.add_argument('--threedsc', default=None, help='3DSC_MP.csv')
    p.add_argument('--sodnet', default=None, help='SODNet SuperCon CSV')
    p.add_argument('--manual-hydrides', action='store_true',
                   help='append the 12 curated DAC hydride entries')
    p.add_argument('--exclude-existing', default=None,
                   help='already-processed CSV whose compositions are '
                        'skipped (incremental corpus growth)')
    p.add_argument('--add-non-sc', type=int, default=0,
                   help='append N non-SC negatives (Materials Project or '
                        'fallback lists)')
    p.add_argument('--non-sc-dft', default=None,
                   help='CSV of DFT-computed materials (e.g. JARVIS dft_3d) '
                        'to sample non-SC negatives from')
    p.add_argument('--non-sc-dft-n', type=int, default=0,
                   help='how many DFT negatives to sample; 0 = auto-balance '
                        'to the SC row count')
    p.add_argument('--non-sc-max-ehull', type=float, default=0.2,
                   help='stability filter: skip DFT rows with energy above '
                        'hull over this (eV/atom) when the column exists')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--min-tc-sc', type=float, default=0.0,
                   help='rows with Tc > this are labeled superconducting')
    p.add_argument('--featurize', action='store_true',
                   help='append Magpie-style composition feature columns '
                        '(chem/featurize.py)')
    return p


def main(argv=None) -> Path:
    p = build_parser()
    args = p.parse_args(argv)

    from superconductor_vae_tpu_torch.data import parse_formula_composition
    from superconductor_vae_tpu_torch.data import ingest_sources as isrc
    from superconductor_vae_tpu_torch.models.family_classifier import (
        RuleBasedFamilyClassifier)
    from superconductor_vae_tpu_torch.utils.materials_api import MaterialsProjectClient

    merged: List[Dict] = []
    n_frames = 0
    for s in args.sources:
        rows = load_source(Path(s))
        if rows is not None:
            merged += rows
            n_frames += 1
            print(f'  {s}: {len(rows)} rows')

    # source-specific readers -> normalized schema -> conflict-resolving
    # merge with holdout exclusion (data/ingest_sources.py)
    specific = []
    for flag, reader in (('nemad', isrc.read_nemad), ('mdr', isrc.read_mdr),
                         ('supercon2', isrc.read_supercon2),
                         ('threedsc', isrc.read_threedsc),
                         ('sodnet', isrc.read_sodnet)):
        path = getattr(args, flag)
        if path:
            rows = reader(path)
            specific.append(rows)
            print(f'  {flag}: {len(rows)} rows')
    if args.manual_hydrides:
        specific.append(isrc.manual_hydrides())
        print('  manual_hydrides: 12 rows')
    if specific:
        holdout_json = ROOT / 'data' / 'GENERATIVE_HOLDOUT_DO_NOT_TRAIN.json'
        holdout = (isrc.load_holdout_keys(holdout_json) if holdout_json.exists()
                   else frozenset())
        existing = frozenset()
        if args.exclude_existing:
            existing = {isrc.canonical_key(_str(f))
                        for f in _read(args.exclude_existing)['formula']}
            existing.discard(None)
        srows, rep = isrc.merge_sources(specific, holdout_keys=holdout,
                                        existing_keys=existing)
        print(f'  merge_sources: {rep}')
        merged += [{'formula': r['formula'], 'Tc': r['Tc'], 'source': r['dataset']}
                   for r in srows]
        n_frames += 1
    if not n_frames:
        p.error('no input rows: pass --sources and/or a specific-source flag')

    # drop unparseable formulas + dedup by (formula, Tc rounded)
    merged = [r for r in merged if len(parse_formula_composition(r['formula'])) > 0]
    seen = set()
    deduped = []
    for r in merged:
        # canonical (p/q) notation: the tokenizer's input format
        r = dict(r, formula=to_fraction_notation(r['formula']))
        key = (r['formula'], float(np.round(r['Tc'], 1)))
        if key not in seen:
            seen.add(key)
            deduped.append(r)
    merged = deduped

    clf = RuleBasedFamilyClassifier()
    fam_to_cat = {
        2: 'Cuprates', 3: 'Cuprates', 4: 'Cuprates', 5: 'Cuprates',
        6: 'Cuprates', 7: 'Cuprates', 8: 'Iron-based', 9: 'Iron-based',
        1: 'Elemental Superconductors', 10: 'Other', 11: 'Other',
        12: 'Organic Superconductors', 13: 'Other',
    }

    def category(formula, sc):
        if not sc:
            return 'Non-SC: Materials Project'
        comp = parse_formula_composition(formula)
        if comp.get('H', 0) / (sum(comp.values()) or 1) > 0.5:
            return 'Hydrogen-rich Superconductors'
        fam = int(clf.classify_from_elements(set(comp)))
        return fam_to_cat.get(fam, 'Other')

    for r in merged:
        sc = int(r['Tc'] > args.min_tc_sc)
        r['is_superconductor'] = sc
        r['requires_high_pressure'] = is_high_pressure(r['formula'], r['Tc']) if sc else 0
        r['category'] = category(r['formula'], sc)

    if args.add_non_sc:
        merged += [{'formula': d['formula'], 'Tc': 0.0, 'source': 'materials_api',
                    'is_superconductor': 0, 'requires_high_pressure': 0,
                    'category': d['category']}
                   for d in MaterialsProjectClient().fetch_non_sc(args.add_non_sc)]

    if args.non_sc_dft:
        from superconductor_vae_tpu_torch.data.pipeline import (
            MAX_ELEMENTS, canonical_composition_key, load_holdout_formulas)
        dft = _read(args.non_sc_dft)
        fcol = next(c for c in FORMULA_COLS if c in dft)
        names = list(dft[fcol])
        if 'ehull' in dft:
            eh = [_number(v) for v in dft['ehull']]
            names = [f for f, e in zip(names, eh)
                     if (1e9 if math.isnan(e) else e) <= args.non_sc_max_ehull]
        # a material screened for superconductivity anywhere in the merged
        # sources (even at Tc=0) must not re-enter as a DFT negative, and no
        # negative may collide with an SC composition or a holdout target
        known = {canonical_composition_key(r['formula']) for r in merged}
        known |= {canonical_composition_key(f) for f in load_holdout_formulas()}
        known.discard(None)
        rows, seen = [], set()
        cand = [c for c in ('' if isinstance(f, float) and math.isnan(f) else str(f).strip()
                            for f in names) if c]
        rng = np.random.default_rng(args.seed)
        rng.shuffle(cand)
        n_sc = sum(r['Tc'] > args.min_tc_sc for r in merged)
        n_have = sum(r['Tc'] <= args.min_tc_sc for r in merged)
        want = args.non_sc_dft_n or max(n_sc - n_have, 0)
        for f in cand:
            comp = parse_formula_composition(f)
            if not comp or len(comp) > MAX_ELEMENTS:
                continue
            spelled = to_fraction_notation(f)
            k = canonical_composition_key(spelled)
            if k is None or k in known or k in seen:
                continue
            seen.add(k)
            rows.append({'formula': spelled, 'Tc': 0.0, 'source': 'jarvis_dft_3d',
                         'is_superconductor': 0, 'requires_high_pressure': 0,
                         'category': 'Non-SC: Materials Project'})
            if len(rows) >= want:
                break
        print(f'  DFT negatives: {len(rows)} sampled '
              f'(want {want}; SC rows {n_sc}, prior negatives {n_have})')
        merged += rows

    if args.featurize:
        from superconductor_vae_tpu_torch.chem.featurize import (FEATURE_NAMES,
                                                                  featurize_formulas)
        feats = featurize_formulas([r['formula'] for r in merged])
        for r, row in zip(merged, feats):
            r.update(zip(FEATURE_NAMES, row))
        print(f'  featurized: {feats.shape[1]} columns')

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_csv(out, merged)
    n_sc = sum(r['is_superconductor'] for r in merged)
    n_hp = sum(r['requires_high_pressure'] for r in merged)
    print(f'wrote {len(merged)} rows ({n_sc} SC, {len(merged) - n_sc} non-SC, '
          f'{n_hp} HP) -> {out}')
    return out


if __name__ == '__main__':
    main()
