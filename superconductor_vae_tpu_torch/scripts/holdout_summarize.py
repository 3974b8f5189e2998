"""Merge a streaming holdout-campaign JSONL into a summary JSON (copied
from scripts/holdout_summarize.py, host only).

The streaming search (``superconductor_vae_tpu_torch.scripts.holdout_search
--stream``) appends one record per finished target; this tool aggregates
them into the summary shape of the 45-target generative holdout (exact /
>=0.99 / >=0.95 counts, the exact matches by information tier).
Deduplicates by target index, keeping the best (exact-preferred, then
highest-similarity) record when a target was re-run.

Usage:
    python -m superconductor_vae_tpu_torch.scripts.holdout_summarize \
        --stream outputs/holdout_stream.jsonl \
        --out outputs/holdout_summary.json \
        [--note "..."] [--checkpoint "..."]
"""
from __future__ import annotations

import argparse
import json


def summarize(records: list[dict]) -> dict:
    best: dict[int, dict] = {}
    for r in records:
        i = int(r.get('index', -1))
        cur = best.get(i)
        key = (bool(r.get('exact')), float(r.get('best_similarity', 0.0)))
        if cur is None or key > (bool(cur.get('exact')),
                                 float(cur.get('best_similarity', 0.0))):
            best[i] = r
    rows = [best[i] for i in sorted(best)]
    sims = [float(r.get('best_similarity', 0.0)) for r in rows]
    n = len(rows)
    tiers = [r.get('exact_tier') for r in rows]
    nav = sum(t == 'navigation' for t in tiers)
    gui = sum(t == 'guided' for t in tiers)
    inv = sum(t == 'inversion' for t in tiers)
    return {
        'targets_completed': n,
        'exact': sum(bool(r.get('exact')) for r in rows),
        # information-budget tiers (HoldoutResult.exact_tier):
        # 'exact_navigation' is the reference-protocol-comparable number
        'exact_navigation': nav,
        'exact_guided_cum': nav + gui,
        'exact_inversion_cum': nav + gui + inv,
        'exact_tier_unattributed': sum(
            bool(r.get('exact')) and r.get('exact_tier')
            in (None, 'mixed') for r in rows),
        'ge_0.99': sum(s >= 0.99 for s in sims),
        'ge_0.95': sum(s >= 0.95 for s in sims),
        'mean_similarity': (sum(sims) / n) if n else 0.0,
        'consistent': sum(bool(r.get('consistent')) for r in rows),
        'exact_targets': [r['target'] for r in rows if r.get('exact')],
        'per_target': rows,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument('--stream', required=True)
    ap.add_argument('--out', required=True)
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--note', default=None)
    args = ap.parse_args(argv)

    records = []
    with open(args.stream) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))

    out = summarize(records)
    if args.checkpoint:
        out = {'checkpoint': args.checkpoint, **out}
    if args.note:
        out = {'note': args.note, **out}
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != 'per_target'},
                     indent=1))
    return out


if __name__ == '__main__':
    main()
