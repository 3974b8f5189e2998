"""One-command, resumable holdout-campaign driver (port of
scripts/holdout_campaign.py):

    python -m superconductor_vae_tpu_torch.scripts.holdout_campaign \\
        --checkpoint <dir> --pallas-decode --budget 8192 \\
        --escalate 12000 16000 --window 5 \\
        --stream outputs/holdout_stream.jsonl --out outputs/holdout_summary.json

Runs the holdout search CLI (``python -m
superconductor_vae_tpu_torch.scripts.holdout_search``) over the targets in
windows of ``--window``, one subprocess for each contiguous run of a
window's unfinished targets, every finished target streamed to a JSONL
with its tier, seed and budget; then reruns the misses at rising budgets
(``--escalate``, seed + round + 1, nearest miss first) and writes the
summary of ``holdout_summarize``.  The windows bound a crash to its
window: a window that ends cleanly leaves a marker in
``<out stem>_shards/`` and is skipped on a rerun, and a window cut short
resumes at its first target missing from the stream at this budget
(``streamed_at_budget``); ``--target-offset`` gives a target the same
random streams in any split.  ``--first-window`` rotates the windows'
order.  The weights' sources, ``--cpu`` and ``--pallas-decode`` pass to
every subprocess; each subprocess prints its K1 launches
(``holdout_search.K1_LINE``).  ``--n-targets`` (a port addition, default
all 45) limits the campaign to the first targets.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

N_HOLDOUT = 45
REPO = Path(__file__).resolve().parents[2]
SEARCH_MODULE = 'superconductor_vae_tpu_torch.scripts.holdout_search'


def source_argv(args) -> list:
    """The weights' source and device flags of ``args``, as the search
    CLI's arguments."""
    argv = (['--checkpoint', str(args.checkpoint)] if args.checkpoint
            else ['--params', str(args.params), '--meta', str(args.meta)])
    return argv + ['--cpu'] * args.cpu + ['--pallas-decode'] * args.pallas_decode


def run_search(argv, timeout=None) -> int:
    """The search CLI in a subprocess with ``argv``; its exit code, -1 if
    it outlived ``timeout`` seconds.  The package is found through
    PYTHONPATH, so that relative paths stay the caller's."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(p for p in (str(REPO), env.get('PYTHONPATH')) if p)
    try:
        return subprocess.run([sys.executable, '-u', '-m', SEARCH_MODULE, *argv],
                              timeout=timeout, env=env).returncode
    except subprocess.TimeoutExpired:
        return -1


def window_order(n_targets: int, window: int, first_window: int) -> list:
    """The windows' first indices in run order: from the first window that
    starts at or after ``first_window``, then wrapping round."""
    starts = list(range(0, n_targets, window))
    pivot = next((i for i, s in enumerate(starts) if s >= first_window), 0)
    return starts[pivot:] + starts[:pivot]


def contiguous_runs(indices) -> list:
    """Sorted indices as [first, count] runs (the search CLI addresses
    targets by offset and count)."""
    runs = []
    for i in indices:
        if runs and i == runs[-1][0] + runs[-1][1]:
            runs[-1][1] += 1
        else:
            runs.append([i, 1])
    return runs


def read_stream(stream: Path) -> list:
    if not stream.exists():
        return []
    return [json.loads(x) for x in stream.read_text().splitlines() if x]


def streamed_at_budget(stream: Path, budget: int) -> set:
    """Target indices already finished in the stream at ``budget`` or
    more: per-target resume, so that a window cut short never reruns (or
    restreams) its finished targets."""
    return {int(r.get('index', -1)) for r in read_stream(stream)
            if int(r.get('budget', 0)) >= budget}


def misses_nearest_first(records) -> list:
    """The stream's non-exact targets (best record each), nearest miss first."""
    from superconductor_vae_tpu_torch.scripts.holdout_summarize import summarize
    misses = [r for r in summarize(records)['per_target'] if not r.get('exact')]
    misses.sort(key=lambda r: -float(r.get('best_similarity', 0.0)))
    return misses


def build_parser() -> argparse.ArgumentParser:
    from superconductor_vae_tpu_torch.scripts.holdout_search import add_source_args
    p = argparse.ArgumentParser()
    add_source_args(p)
    p.add_argument('--csv', default='data/processed/jarvis_merged.csv.gz')
    p.add_argument('--budget', type=int, default=30000)
    p.add_argument('--n-targets', type=int, default=N_HOLDOUT,
                   help='campaign over the first N holdout targets')
    p.add_argument('--window', type=int, default=5, help='targets per subprocess')
    p.add_argument('--refine-rounds', type=int, default=2)
    p.add_argument('--guided-starts', type=int, default=32)
    p.add_argument('--sample-slice', type=int, default=4096)
    p.add_argument('--sample-draws', type=int, default=2)
    p.add_argument('--decode-chunk', type=int, default=2048)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--strategy-order', default='tiered',
                   choices=['tiered', 'inversion_first'])
    p.add_argument('--no-guided', action='store_true',
                   help='skip the guided tier (passed to the search CLI)')
    p.add_argument('--no-inverse', action='store_true')
    p.add_argument('--no-oracle', action='store_true',
                   help='skip the in-campaign oracle diagnostic (the '
                        'standalone --oracle-only run gives the same number)')
    p.add_argument('--inversion-steps', type=int, default=384)
    p.add_argument('--constrain-elements', action='store_true')
    p.add_argument('--no-snap-stoich', action='store_true',
                   help='disable the rational snap of the predicted stoich '
                        'conditioning')
    p.add_argument('--shard-timeout', type=int, default=3600,
                   help='seconds per window subprocess')
    p.add_argument('--first-window', type=int, default=0,
                   help='window start index to process first; the windows are '
                        'rotated (their outputs are cached, so the order does '
                        'not change the results)')
    p.add_argument('--stream', default=None,
                   help='JSONL receiving every finished target as it lands; '
                        'default: <out stem>_stream.jsonl')
    p.add_argument('--escalate', type=int, nargs='*', default=[],
                   help='after the base pass, rerun the remaining misses one '
                        'target at a time at these budgets in order (the '
                        'stream keeps the best record of each target)')
    p.add_argument('--escalate-timeout', type=int, default=2400,
                   help='seconds per escalation rerun')
    p.add_argument('--out', required=True)
    return p


def main(argv=None) -> dict:
    from superconductor_vae_tpu_torch.scripts.holdout_search import (
        parse_source_args, source_name)
    from superconductor_vae_tpu_torch.scripts.holdout_summarize import summarize
    args = parse_source_args(build_parser(), argv)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    shard_dir = out.parent / (out.stem + '_shards')
    shard_dir.mkdir(parents=True, exist_ok=True)
    stream = Path(args.stream) if args.stream else out.parent / (out.stem + '_stream.jsonl')
    n_total = args.n_targets

    def base_argv(budget, seed):
        argv = source_argv(args) + [
            '--csv', args.csv, '--budget', str(budget),
            '--refine-rounds', str(args.refine_rounds),
            '--guided-starts', str(args.guided_starts),
            '--sample-slice', str(args.sample_slice),
            '--sample-draws', str(args.sample_draws),
            '--decode-chunk', str(args.decode_chunk),
            '--seed', str(seed),
            '--strategy-order', args.strategy_order,
            '--inversion-steps', str(args.inversion_steps),
            '--stream', str(stream)]
        for flag in ('no_guided', 'no_inverse', 'constrain_elements', 'no_snap_stoich',
                     'no_oracle'):
            if getattr(args, flag):
                argv.append('--' + flag.replace('_', '-'))
        return argv

    for lo in window_order(n_total, args.window, args.first_window):
        n = min(args.window, n_total - lo)
        shard_out = shard_dir / f'shard_{lo:02d}.json'
        if shard_out.exists():
            print(f'[campaign] shard {lo}..{lo + n - 1}: cached', flush=True)
            continue
        done = streamed_at_budget(stream, args.budget)
        missing = [i for i in range(lo, lo + n) if i not in done]
        if not missing:
            print(f'[campaign] shard {lo}..{lo + n - 1}: all targets already streamed',
                  flush=True)
            continue
        rc = 0
        for r_lo, r_n in contiguous_runs(missing):
            print(f'[campaign] targets {r_lo}..{r_lo + r_n - 1}: running', flush=True)
            rc = run_search(base_argv(args.budget, args.seed) + [
                '--target-offset', str(r_lo), '--n-targets', str(r_n),
                '--out', str(shard_dir / f'run_{r_lo:02d}_{r_n}.json')], args.shard_timeout)
            if rc != 0:
                print(f'[campaign] targets {r_lo}..{r_lo + r_n - 1} FAILED rc={rc} '
                      f'(finished targets live in the stream)', flush=True)
        if rc == 0:
            # a marker only: the per-target records live in the stream
            shard_out.write_text(json.dumps({'targets': list(range(lo, lo + n)),
                                             'via': 'stream'}))

    # escalation: the remaining misses one at a time at a bigger budget and
    # a fresh seed; the stream keeps each target's best record, so a rerun
    # can only improve the summary
    for round_i, budget in enumerate(args.escalate):
        misses = misses_nearest_first(read_stream(stream))
        if not misses:
            break
        print(f'[campaign] escalation budget={budget}: {len(misses)} misses', flush=True)
        for r in misses:
            idx = int(r['index'])
            if run_search(base_argv(budget, args.seed + round_i + 1) + [
                    '--target-offset', str(idx), '--n-targets', '1',
                    '--out', str(shard_dir / f'rerun_{budget}_{idx:02d}.json')],
                    args.escalate_timeout) == -1:
                print(f'[campaign] rerun [{idx}] timed out', flush=True)

    summary = summarize(read_stream(stream))
    summary = {
        'checkpoint': source_name(args), 'budget': args.budget,
        'escalate': args.escalate, 'seed': args.seed,
        'strategy_order': args.strategy_order,
        'n_missing': n_total - summary['targets_completed'],
        **summary,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != 'per_target'}, indent=2))
    out.write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == '__main__':
    main()
