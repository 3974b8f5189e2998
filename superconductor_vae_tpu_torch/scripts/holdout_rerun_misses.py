"""Rerun the non-exact holdout targets at a higher search budget (port of
scripts/holdout_rerun_misses.py):

    python -m superconductor_vae_tpu_torch.scripts.holdout_rerun_misses \\
        --stream outputs/holdout_stream.jsonl --checkpoint <dir> \\
        --budget 24000 --refine-rounds 2 [--pallas-decode] [--max-targets 8] [--dry-run]

Reads a campaign stream, picks the targets without an exact match
(deduplicated by ``holdout_summarize.summarize``), nearest miss first,
where a zoom-in is likeliest to flip the result, and reruns each as its
own subprocess of the holdout search CLI (``--target-offset i
--n-targets 1``) appending to the same stream; the summary keeps each
target's best record, so a rerun can only improve it.  ``--dry-run``
prints the plan and launches nothing.  The weights' sources, ``--cpu``
and ``--pallas-decode`` pass to every subprocess.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def pick_misses(stream_path: str, max_targets: int | None) -> list[dict]:
    from superconductor_vae_tpu_torch.scripts.holdout_campaign import misses_nearest_first
    records = [json.loads(line) for line in Path(stream_path).read_text().splitlines()
               if line.strip()]
    misses = misses_nearest_first(records)
    return misses[:max_targets] if max_targets else misses


def main(argv=None) -> list[dict]:
    from superconductor_vae_tpu_torch.scripts.holdout_campaign import run_search, source_argv
    from superconductor_vae_tpu_torch.scripts.holdout_search import (
        add_source_args, parse_source_args)
    ap = argparse.ArgumentParser()
    add_source_args(ap)
    ap.add_argument('--stream', required=True)
    ap.add_argument('--csv', default='data/processed/jarvis_merged.csv.gz')
    ap.add_argument('--budget', type=int, default=24000)
    ap.add_argument('--refine-rounds', type=int, default=2)
    ap.add_argument('--guided-starts', type=int, default=24)
    ap.add_argument('--seed', type=int, default=1,
                    help='another seed than the base campaign\'s, so that the '
                         'rerun explores fresh perturbations')
    ap.add_argument('--strategy-order', default='tiered',
                    choices=['tiered', 'inversion_first'])
    ap.add_argument('--constrain-elements', action='store_true')
    ap.add_argument('--max-targets', type=int, default=None)
    ap.add_argument('--timeout', type=int, default=2400, help='seconds per target')
    ap.add_argument('--dry-run', action='store_true',
                    help='print the rerun plan without launching')
    args = parse_source_args(ap, argv)

    misses = pick_misses(args.stream, args.max_targets)
    print(f'{len(misses)} non-exact targets queued '
          f'(budget {args.budget}, refine {args.refine_rounds}):')
    for r in misses:
        print(f"  [{r['index']}] sim={r['best_similarity']:.4f} {r['target']}")
    if args.dry_run:
        return misses

    out_dir = Path(args.stream).parent
    for r in misses:
        idx = int(r['index'])
        print(f'--- rerun [{idx}] {r["target"]}', flush=True)
        rc = run_search(source_argv(args) + [
            '--csv', args.csv, '--budget', str(args.budget),
            '--refine-rounds', str(args.refine_rounds),
            '--guided-starts', str(args.guided_starts), '--seed', str(args.seed),
            '--target-offset', str(idx), '--n-targets', '1',
            '--strategy-order', args.strategy_order, '--stream', args.stream,
            '--out', str(out_dir / f'holdout_rerun_{idx}.json')]
            + ['--constrain-elements'] * args.constrain_elements, args.timeout)
        if rc == -1:
            print(f'[{idx}] timed out after {args.timeout}s; '
                  'the stream keeps the original record', flush=True)
    return misses


if __name__ == '__main__':
    main()
