"""Build the fraction and isotope vocabularies from a training CSV (port
of scripts/build_vocab.py; host only):

    python -m superconductor_vae_tpu_torch.scripts.build_vocab \\
        --csv <training.csv> --out data/

Scans every formula for ``(p/q)`` fractions, reduces each by its GCD,
orders them by descending frequency and writes ``fraction_vocab.json``;
``isotope_vocab.json`` lists ``chem/isotopes.py`` ``ISOTOPES``.  The CSV
is read with the standard library (``data/pipeline.py``), as pandas reads
it, so that both files are byte-equal to the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import math
import re
from collections import Counter
from pathlib import Path

_FRAC = re.compile(r'\((\d+)/(\d+)\)')


def build_fraction_vocab(formulas, out_path: Path) -> dict:
    counts = Counter()
    for f in formulas:
        for m in _FRAC.finditer(str(f)):
            p, q = int(m.group(1)), int(m.group(2))
            g = math.gcd(p, q) or 1
            counts[f'{p // g}/{q // g}'] += 1
    ordered = [frac for frac, _ in counts.most_common()]
    total = sum(counts.values())

    def coverage(top_pct):
        target = total * top_pct
        acc = 0
        for i, (_, c) in enumerate(counts.most_common(), 1):
            acc += c
            if acc >= target:
                return i
        return len(ordered)

    blob = {
        'version': 'V13.0',
        'description': 'Semantic fraction vocabulary (frequency-ordered)',
        'n_formulas': len(formulas),
        'n_fractions': len(ordered),
        'total_fraction_occurrences': total,
        'coverage': {f'top_{p}pct': coverage(p / 100)
                     for p in (50, 90, 95, 99, 100)},
        'fractions': ordered,
    }
    out_path.write_text(json.dumps(blob, indent=2))
    print(f'fraction vocab: {len(ordered)} fractions '
          f'({total} occurrences) -> {out_path}')
    return blob


def build_isotope_vocab(out_path: Path) -> dict:
    from superconductor_vae_tpu_torch.chem.isotopes import ISOTOPES
    blob = {
        'version': 'V14.0',
        'description': 'Isotope vocabulary — single semantic token per isotope',
        'n_isotopes': len(ISOTOPES),
        'isotopes': list(ISOTOPES),
    }
    out_path.write_text(json.dumps(blob, indent=2))
    print(f'isotope vocab: {len(ISOTOPES)} isotopes -> {out_path}')
    return blob


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--csv', required=True)
    p.add_argument('--out', default='data')
    p.add_argument('--formula-column', default='formula')
    args = p.parse_args(argv)

    from superconductor_vae_tpu_torch.data.pipeline import _read_csv_columns
    formulas = _read_csv_columns(args.csv)[args.formula_column].tolist()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    build_fraction_vocab(formulas, out / 'fraction_vocab.json')
    build_isotope_vocab(out / 'isotope_vocab.json')


if __name__ == '__main__':
    main()
