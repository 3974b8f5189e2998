"""The Phase-2 self-supervised training dashboard (port of
scripts/phase2_dashboard.py): overview, loss-signal trends, z-space
quality, discoveries and holdout hits, as text, from a run's logs:

    <output>/phase2_log.jsonl          (a line a sub-epoch, train())
    <output>/phase2_discoveries.jsonl  (novel validated formulas)
    <output>/holdout_results.json      (optional)

    python -m superconductor_vae_tpu_torch.scripts.phase2_dashboard outputs
"""

import argparse
import json
from pathlib import Path


def load_jsonl(path):
    if not path.exists():
        return []
    rows = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if line:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return rows


def trend(first, latest):
    if isinstance(first, (int, float)) and abs(first) > 1e-12:
        return f'{(latest - first) / abs(first) * 100:+.1f}%'
    return 'n/a'


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('run_dir', nargs='?', default='outputs')
    args = p.parse_args(argv)
    run = Path(args.run_dir)
    if run.is_file():          # accept a direct path to phase2_log.jsonl
        run = run.parent

    rows = load_jsonl(run / 'phase2_log.jsonl')
    discoveries = load_jsonl(run / 'phase2_discoveries.jsonl')

    print('=' * 70)
    print('PHASE 2 SELF-SUPERVISED DASHBOARD')
    print('=' * 70)
    if not rows:
        print(f'  no Phase-2 sub-epochs logged in {run}/phase2_log.jsonl')
        print('  (enable with --set phase2_enabled=true; activates once '
              'TF exact >= phase2_auto_min_exact)')
        if discoveries:
            print(f'  ...but {len(discoveries)} discoveries logged:')
            for d in discoveries[:10]:
                print(f"    {d.get('formula')}  {d.get('meta')}")
        return

    first, latest = rows[0], rows[-1]
    print(f"  sub-epochs: {len(rows)}   epochs "
          f"{first.get('epoch')} -> {latest.get('epoch')}")
    print(f"  current weight: {latest.get('phase2_weight', 0):.4f}   "
          f"sigma: {latest.get('sigma', 0):.3f}   "
          f"explore temp: {latest.get('explore_temp', 0):.2f}")

    print(f"\n{' LOSS SIGNALS ':=^62}")
    print(f"  {'metric':<24}{'first':>10}{'latest':>10}{'trend':>10}")
    for key in ('phase2_loss', 'loss1_round_trip', 'loss2_consistency',
                'loss3_physics', 'loss4_reinforce', 'round_trip_z_mse',
                'tc_mse'):
        if key in latest:
            f_, l_ = first.get(key, 0.0), latest[key]
            print(f'  {key:<24}{f_:>10.4f}{l_:>10.4f}'
                  f'{trend(f_, l_):>10}')

    print(f"\n{' Z-SPACE QUALITY ':=^62}")
    print(f"  {'metric':<24}{'first':>10}{'latest':>10}{'target':>10}")
    for key, target in (('n_sampled', '-'), ('n_accepted', '-'),
                        ('unique_rate', '> 0.30'), ('n_novel', '-'),
                        ('holdout_hits', '-')):
        if key in latest:
            print(f"  {key:<24}{first.get(key, 0):>10.3f}"
                  f"{latest[key]:>10.3f}{target:>10}")
    accept = latest.get('n_accepted', 0) / max(latest.get('n_sampled', 1), 1)
    print(f"  {'accept_rate':<24}{'':>10}{accept:>10.3f}{'> 0.50':>10}")

    collapses = sum(1 for r in rows if r.get('mode_collapsed'))
    print(f"\n  mode collapses: {collapses}/{len(rows)} sub-epochs"
          + ('  (intervention: temp boost + RT-weight mult)'
             if collapses else ''))

    print(f"\n{' DISCOVERIES ':=^62}")
    print(f'  novel validated formulas: {len(discoveries)}')
    for d in discoveries[-10:]:
        ep = d.get('epoch', (d.get('meta') or {}).get('epoch', '?'))
        print(f"    {d.get('formula', '?'):<40} sub-epoch {ep}")

    hpath = run / 'holdout_results.json'
    if hpath.exists():
        blob = json.loads(hpath.read_text())
        s = blob.get('summary', blob)
        print(f"\n{' HOLDOUT SEARCH ':=^62}")
        print(f"  exact {s.get('exact')}/{s.get('n_targets')}   "
              f">=0.99: {s.get('sim_ge_99')}   >=0.95: {s.get('sim_ge_95')}  "
              f" mean sim {s.get('mean_similarity', 0):.4f}")


if __name__ == '__main__':
    main()
