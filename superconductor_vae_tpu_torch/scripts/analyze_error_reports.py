"""Mines the per-eval error-record JSONLs of a training run for failure
patterns (port of scripts/analyze_error_reports.py).

The records are the ones ``train()`` writes every
``error_report_interval`` epochs (training/train_loop.py,
``<output>/error_reports/epoch_NNNNN.jsonl``: index, formula, generated,
tc_kelvin, z_norm, family).  It prints the error-count trend, errors by
Tc range, family, z-norm quartile and element count, the error-pattern
taxonomy (element substitution, missing, extra, order, amount), the
precision of wrong amounts, the first divergence position, the top
element substitutions and the formulas that fail in several reports, as
the JAX script does, line for line.

    python -m superconductor_vae_tpu_torch.scripts.analyze_error_reports outputs/error_reports
    python -m superconductor_vae_tpu_torch.scripts.analyze_error_reports outputs/error_reports --last
"""

import argparse
import json
from collections import Counter
from pathlib import Path

import numpy as np

from superconductor_vae_tpu_torch.data.canonical_ordering import parse_ordered


def load_reports(path: Path):
    """-> {epoch: [records]} from epoch_NNNNN.jsonl files."""
    reports = {}
    for f in sorted(path.glob('epoch_*.jsonl')):
        recs = [json.loads(line) for line in f.read_text().splitlines() if line]
        if recs:
            reports[recs[0].get('epoch', int(f.stem.split('_')[1]))] = recs
    return reports


def diff_formulas(target: str, generated: str):
    """Classify how the generation diverged from the target.

    Returns a dict of pattern flags mirroring the reference's
    ``analyze_error_patterns`` taxonomy: element substitution / missing /
    extra, amount (fraction) errors with near-miss detection, and ordering
    errors (same multiset, wrong order).
    """
    t = parse_ordered(target)
    g = parse_ordered(generated)
    t_elems = [e[0] for e in t]
    g_elems = [e[0] for e in g]
    out = {
        'n_elements_target': len(t), 'n_elements_generated': len(g),
        'element_set_match': set(t_elems) == set(g_elems),
        'element_order_match': t_elems == g_elems,
        'missing_elements': sorted(set(t_elems) - set(g_elems)),
        'extra_elements': sorted(set(g_elems) - set(t_elems)),
        'amount_errors': [],
        'first_divergence': None,
    }
    for i, (te, ge) in enumerate(zip(t, g)):
        if te[0] != ge[0] or te[1] != ge[1]:
            out['first_divergence'] = i
            break
    else:
        if len(t) != len(g):
            out['first_divergence'] = min(len(t), len(g))
    if out['element_set_match']:
        t_amt = {e[0]: (e[1], e[2]) for e in t}
        for sym, amt_str, val in g:
            ts, tv = t_amt.get(sym, ('', 1.0))
            if amt_str != ts:
                rel = abs(val - tv) / max(abs(tv), 1e-9)
                out['amount_errors'].append(
                    {'element': sym, 'target': ts or '1', 'got': amt_str or '1',
                     'rel_error': rel, 'near_miss': rel < 0.1})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('report_dir')
    p.add_argument('--last', action='store_true',
                   help='analyze only the newest report')
    p.add_argument('--top', type=int, default=12)
    args = p.parse_args(argv)

    reports = load_reports(Path(args.report_dir))
    if not reports:
        print('no error reports found')
        return
    epochs = sorted(reports)

    # ---- trend across epochs ------------------------------------------------
    print('=== error-count trend ===')
    for e in epochs:
        print(f'  epoch {e:5d}: {len(reports[e]):5d} errors')

    if args.last:
        epochs = epochs[-1:]
    recs = [r for e in epochs for r in reports[e]]
    print(f'\nanalyzing {len(recs)} error records from epochs {epochs}')

    # ---- Tc-range buckets ----------------------------------------------------
    bins = [(0, 1), (1, 10), (10, 50), (50, 100), (100, 1000)]
    by_tc = Counter()
    for r in recs:
        for lo, hi in bins:
            if lo <= r['tc_kelvin'] < hi:
                by_tc[f'{lo}-{hi}K'] += 1
                break
    print('\n=== errors by Tc range ===')
    for k, v in by_tc.most_common():
        print(f'  {k:>10}: {v:5d} ({100 * v / len(recs):.1f}%)')

    # ---- family distribution --------------------------------------------------
    by_fam = Counter(r.get('family', -1) for r in recs)
    print('\n=== errors by family label ===')
    for k, v in by_fam.most_common():
        print(f'  family {k:3d}: {v:5d}')

    # ---- z-norm quartiles ------------------------------------------------------
    zn = np.array([r['z_norm'] for r in recs])
    print('\n=== z-norm quartiles of failing samples ===')
    print(f'  q25={np.percentile(zn, 25):.2f}  median={np.median(zn):.2f}  '
          f'q75={np.percentile(zn, 75):.2f}  max={zn.max():.2f}')

    # ---- sequence-length buckets ------------------------------------------------
    by_len = Counter()
    for r in recs:
        n = len(parse_ordered(r['formula']))
        by_len[n] += 1
    print('\n=== errors by element count ===')
    for k in sorted(by_len):
        print(f'  {k} elements: {by_len[k]:5d}')

    # ---- error-pattern taxonomy ---------------------------------------------------
    pat = Counter()
    amount_rel = []
    near_miss = 0
    n_amount = 0
    div_pos = Counter()
    elem_subs = Counter()
    for r in recs:
        d = diff_formulas(r['formula'], r.get('generated', ''))
        if not d['element_set_match']:
            if d['missing_elements'] and not d['extra_elements']:
                pat['missing_element'] += 1
            elif d['extra_elements'] and not d['missing_elements']:
                pat['extra_element'] += 1
            else:
                pat['element_substitution'] += 1
                for m, x in zip(d['missing_elements'], d['extra_elements']):
                    elem_subs[f'{m}->{x}'] += 1
        elif not d['element_order_match']:
            pat['element_order'] += 1
        elif d['amount_errors']:
            pat['amount_only'] += 1
        else:
            pat['length_or_padding'] += 1
        for a in d['amount_errors']:
            n_amount += 1
            amount_rel.append(a['rel_error'])
            near_miss += a['near_miss']
        if d['first_divergence'] is not None:
            div_pos[d['first_divergence']] += 1
    print('\n=== error patterns ===')
    for k, v in pat.most_common():
        print(f'  {k:22s}: {v:5d} ({100 * v / len(recs):.1f}%)')

    # ---- fraction precision ---------------------------------------------------------
    if amount_rel:
        ar = np.array(amount_rel)
        print('\n=== amount (fraction) precision ===')
        print(f'  {n_amount} wrong amounts; rel-error median '
              f'{np.median(ar):.3f}, near-miss (<10%): '
              f'{100 * near_miss / n_amount:.1f}%')

    # ---- first-divergence position --------------------------------------------------
    print('\n=== first divergence position (element slot) ===')
    for k in sorted(div_pos)[:8]:
        print(f'  slot {k}: {div_pos[k]:5d}')

    # ---- top confused substitutions ---------------------------------------------------
    if elem_subs:
        print('\n=== top element substitutions ===')
        for k, v in elem_subs.most_common(args.top):
            print(f'  {k:10s}: {v:4d}')

    # ---- hardest formulas (recurring across epochs) -----------------------------------
    freq = Counter(r['formula'] for e in sorted(reports) for r in reports[e])
    recurring = [(f, c) for f, c in freq.most_common(args.top) if c > 1]
    if recurring:
        print('\n=== recurring failures (across reports) ===')
        for f, c in recurring:
            print(f'  {c:3d}x  {f}')


if __name__ == '__main__':
    main()
