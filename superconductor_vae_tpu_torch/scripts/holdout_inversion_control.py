"""Control experiment for the decoder-inversion holdout tier (port of
scripts/holdout_inversion_control.py), on the card unless ``--cpu``:

    python -m superconductor_vae_tpu_torch.scripts.holdout_inversion_control \\
        --checkpoint <dir> [--pallas-decode] --n-scrambled 24 --n-non-sc 12 \\
        --out outputs/inversion_control.json

The inversion tier descends z on the teacher-forced cross-entropy of the
exact target sequence, the very quantity that defines an exact match.  If
it also "recovers" compositions that are not superconductors and were
never trained on, its holdout hits measure the decoder's invertibility,
not generalisation.  Two control sets, both absent from the corpus and the
holdout list at composition level:

1. ``scrambled``: holdout targets with their amounts deranged across their
   elements (same tokens and length, implausible stoichiometry);
2. ``mutated_non_sc``: non-SC corpus rows with one amount nudged to an
   adjacent fraction, checked to tokenize without UNK.

Both are drawn with Python's ``random.Random(seed)`` and ``Fraction``, as
the JAX script draws them, so that a seed gives the JAX script's control
sets.  The attack is the campaign's inversion arm (greedy pool, guided
and inverse-regression tiers off, ``inversion_first``); ``summary.by_kind``
counts the exact hits of each set.  The weights' sources and
``--pallas-decode`` are the holdout CLI's (scripts/holdout_search.py).
"""

from __future__ import annotations

import argparse
import json
import random
from fractions import Fraction
from pathlib import Path


def spell_alphabetical(comp: dict) -> str:
    """{el: amount} -> canonical alphabetical (p/q) spelling."""
    parts = []
    for el in sorted(comp):
        amt = Fraction(comp[el]).limit_denominator(100000)
        parts.append(el)
        if amt == 1:
            continue
        parts.append(str(int(amt)) if amt.denominator == 1
                     else f'({amt.numerator}/{amt.denominator})')
    return ''.join(parts)


def build_scrambled(targets, corpus_keys, holdout_keys, parse, key_fn, rng, n_out):
    out = []
    for t in targets:
        comp = parse(t)
        els = sorted(comp)
        amts = [comp[e] for e in els]
        if len(els) < 3 or len(set(amts)) < 2:
            continue
        for _ in range(20):
            perm = list(amts)
            rng.shuffle(perm)
            if perm == amts:
                continue
            cand = dict(zip(els, perm))
            k = key_fn(spell_alphabetical(cand))
            if k is None or k in corpus_keys or k in holdout_keys:
                continue
            out.append(spell_alphabetical(cand))
            break
        if len(out) >= n_out:
            break
    return out


def build_mutated_non_sc(ds, corpus_keys, holdout_keys, parse, key_fn, rng, n_out,
                         tokenizer):
    from superconductor_vae_tpu_torch.tokenizer import FRAC_UNK_ID, UNK_ID
    out = []
    idx = [i for i, sc in enumerate(ds.is_sc) if sc == 0]
    rng.shuffle(idx)
    for i in idx:
        comp = parse(ds.formulas[i])
        if len(comp) < 2:
            continue
        el = rng.choice(sorted(comp))
        f = Fraction(comp[el]).limit_denominator(1000)
        # the numerator nudged by one against a doubled denominator, which
        # stays in the fraction vocab more often, or the amount plus one
        cand_amts = [Fraction(f.numerator * 2 + 1, f.denominator * 2),
                     Fraction(max(f.numerator * 2 - 1, 1), f.denominator * 2),
                     f + 1]
        for amt in cand_amts:
            trial = dict(comp)
            trial[el] = float(amt)
            spelled = spell_alphabetical(trial)
            k = key_fn(spelled)
            if k is None or k in corpus_keys or k in holdout_keys:
                continue
            ids = tokenizer.encode(spelled)
            if UNK_ID in ids or FRAC_UNK_ID in ids:
                continue
            out.append(spelled)
            break
        if len(out) >= n_out:
            break
    return out


def main(argv=None):
    from superconductor_vae_tpu_torch.scripts.holdout_search import (
        add_source_args, build_pipeline, parse_source_args, print_k1_launches)
    p = argparse.ArgumentParser()
    add_source_args(p)
    p.add_argument('--csv', default='data/processed/jarvis_merged.csv.gz')
    p.add_argument('--n-scrambled', type=int, default=24)
    p.add_argument('--n-non-sc', type=int, default=12)
    p.add_argument('--budget', type=int, default=64,
                   help='the small pool decoded beside the inversion (the '
                        'campaign flow; the inversion is the tier under test)')
    p.add_argument('--inversion-starts', type=int, default=24)
    p.add_argument('--inversion-steps', type=int, default=384)
    p.add_argument('--refine-rounds', type=int, default=1)
    p.add_argument('--decode-chunk', type=int, default=256,
                   help='a small fixed decode batch: the control pools are tiny')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--out', default='outputs/inversion_control.json')
    args = parse_source_args(p, argv)

    from superconductor_vae_tpu_torch.data.pipeline import (
        canonical_composition_key, parse_formula_composition)
    from superconductor_vae_tpu_torch.generation.holdout_search import HoldoutSearch
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention

    launches0 = decode_step_attention.launches
    pipe, _ = build_pipeline(args)
    search = HoldoutSearch(pipe)
    ds = pipe.ds
    corpus_keys = {canonical_composition_key(f) for f in ds.formulas}
    holdout_keys = {canonical_composition_key(f) for f in search.targets}
    rng = random.Random(args.seed)
    scrambled = build_scrambled(search.targets, corpus_keys, holdout_keys,
                                parse_formula_composition, canonical_composition_key, rng,
                                args.n_scrambled)
    mutated = build_mutated_non_sc(ds, corpus_keys, holdout_keys, parse_formula_composition,
                                   canonical_composition_key, rng, args.n_non_sc,
                                   pipe.tokenizer)
    controls = ([('scrambled', f) for f in scrambled]
                + [('mutated_non_sc', f) for f in mutated])
    print(f'{len(scrambled)} scrambled + {len(mutated)} mutated non-SC control targets')

    # the search machinery pointed at the control list: the campaign's
    # inversion arm (anchors -> TF-CE descent -> greedy and pure-argmax
    # decodes -> fan), guided and inverse regression off, a greedy pool
    search.targets = [f for _, f in controls]
    search.target_tc = {}
    results = search.search(
        budget_per_target=args.budget, seed=args.seed,
        targets=search.targets, temperature_sweep=(0.0,),
        refine_rounds=args.refine_rounds, guided=False,
        inverse_regression=False, inversion=True,
        inversion_starts=args.inversion_starts,
        inversion_steps=args.inversion_steps,
        decode_chunk=args.decode_chunk,
        oracle_diagnostic=False, check_consistency=True,
        strategy_order='inversion_first')

    rows = [{'kind': kind, 'target': f, 'exact': r.exact,
             'best_match': r.best_match, 'best_similarity': r.best_similarity,
             'found_by': r.found_by, 'inversion_diag': r.inversion_diag,
             'consistent': r.consistent, 'consistency': r.consistency}
            for (kind, f), r in zip(controls, results)]
    n = len(rows)
    n_exact = sum(r['exact'] for r in rows)
    by_kind = {}
    for k in ('scrambled', 'mutated_non_sc'):
        sub = [r for r in rows if r['kind'] == k]
        by_kind[k] = {'n': len(sub), 'exact': sum(r['exact'] for r in sub)}
    summary = {
        'n_controls': n, 'exact': n_exact,
        'hit_rate': n_exact / n if n else 0.0,
        'by_kind': by_kind,
        'interpretation': (
            'A hit rate near the holdout inversion rate means the '
            'inversion strategy measures decoder invertibility (any '
            'in-vocab sequence can be forced), not latent-space '
            'generalization; holdout exacts found ONLY by inversion must '
            'not be compared against the reference 12/45 protocol.'),
    }
    print(json.dumps(summary, indent=2))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({'summary': summary, 'results': rows}, indent=2))
    print_k1_launches(launches0)
    return {'summary': summary, 'results': rows}


if __name__ == '__main__':
    main()
