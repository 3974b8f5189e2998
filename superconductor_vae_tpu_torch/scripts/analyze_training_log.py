"""Training-log analytics (port of scripts/analyze_training_log.py): mines
a run's training_metrics.csv for peaks, loss transitions, phases,
milestones, plateaus, sudden events, the recent trend, an epoch table and
the correlations with the TF exact match, printing what the JAX script
prints, line for line.

The JAX script reads the CSV with pandas, which the card's machine lacks:
here the standard library reads it into float64 columns (an empty cell is
NaN), and the few pandas operations it used are written out (means skip
NaN, a correlation is Pearson's over the rows where both columns have a
value, in pandas' one-pass order, NaN for a constant column; the sort
puts NaN last).

    python -m superconductor_vae_tpu_torch.scripts.analyze_training_log outputs/training_metrics.csv
"""

import argparse
import csv
from typing import Dict, List

import numpy as np

NEAR_ZERO = 1e-3


def hr(title):
    print('=' * 78)
    print(title)
    print('=' * 78)


def _number(cell: str) -> float:
    try:
        return float(cell)
    except ValueError:
        return float('nan')


def read_log(path) -> Dict[str, np.ndarray]:
    """{column: float64 values} of the CSV's numeric columns, in order;
    a resumed run appends, so only the last row of each epoch is kept."""
    with open(path, newline='') as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    header, body = rows[0], [r for r in rows[1:] if r]
    cols: Dict[str, np.ndarray] = {}
    for j, name in enumerate(header):
        cells = [r[j] if j < len(r) else '' for r in body]
        values = np.array([_number(c) for c in cells], dtype=np.float64)
        if any(c != '' and np.isnan(v) for c, v in zip(cells, values)):
            continue                       # not a numeric column
        cols[name] = values
    if 'epoch' in cols:
        ep = cols['epoch']
        keep = np.array([not (ep[i + 1:] == ep[i]).any() for i in range(len(ep))],
                        dtype=bool)
        cols = {k: v[keep] for k, v in cols.items()}
    return cols


def _nanmean(v: np.ndarray) -> float:
    v = v[~np.isnan(v)]
    return float(v.mean()) if len(v) else float('nan')


def _corr(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson's r over the rows where both have a value, in pandas'
    one-pass (Welford) order; NaN where a column is constant."""
    n = mx = my = sxx = syy = sxy = 0.0
    for vx, vy in zip(x.tolist(), y.tolist()):
        if vx != vx or vy != vy:
            continue
        n += 1
        dx, dy = vx - mx, vy - my
        mx += dx / n
        my += dy / n
        sxx += (vx - mx) * dx
        syy += (vy - my) * dy
        sxy += (vx - mx) * dy
    div = np.sqrt(sxx * syy)
    return float(sxy / div) if n >= 1 and div != 0 else float('nan')


def _sorted_nan_last(items: List) -> List:
    finite = sorted((kv for kv in items if not np.isnan(kv[1])), key=lambda kv: kv[1])
    return finite + [kv for kv in items if np.isnan(kv[1])]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('csv')
    p.add_argument('--plateau-window', type=int, default=20)
    p.add_argument('--plateau-threshold', type=float, default=0.01)
    p.add_argument('--trend-window', type=int, default=50)
    p.add_argument('--table-every', type=int, default=25)
    args = p.parse_args(argv)

    df = read_log(args.csv)
    n = len(next(iter(df.values()))) if df else 0
    if n == 0:
        print('empty log')
        return
    epoch = df['epoch']
    obs = []

    # -- peaks ---------------------------------------------------------------
    hr('PEAKS')
    for col in ('exact_match', 'true_ar_exact'):
        if col not in df:
            continue
        i = int(np.nanargmax(df[col]))
        print(f"  peak {col}: {df[col][i]:.4f} ({df[col][i]*100:.2f}%) at epoch "
              f"{int(epoch[i])} (loss {df['total'][i]:.3f})")
        obs.append(f'peak {col} {df[col][i]*100:.2f}% @ {int(epoch[i])}')
    print(f"  final: exact={df['exact_match'][-1]:.4f} "
          f"AR={df['true_ar_exact'][-1]:.4f} "
          f"epoch {int(epoch[-1])}")

    # -- loss transitions (when terms reached ~0) ----------------------------
    hr('LOSS TRANSITIONS (first epoch each term dropped under 1e-3)')
    loss_cols = [c for c in df if c.endswith('_loss') or c in ('total', 'entropy')]
    for col in loss_cols:
        v = df[col]
        if not np.isfinite(v).any():
            print(f'  {col}: no data')
            continue
        if np.nanmax(np.abs(v)) < NEAR_ZERO:
            print(f'  {col}: always ~0 (max {np.nanmax(np.abs(v)):.2e})')
            continue
        under = np.where(np.abs(v) < NEAR_ZERO)[0]
        if len(under):
            print(f'  {col}: first ~0 at epoch {int(epoch[under[0]])} '
                  f'(start {v[0]:.3f})')
        else:
            print(f'  {col}: {v[0]:.3f} -> {v[-1]:.4f} (never ~0)')

    # -- phases from controller activations ----------------------------------
    hr('PHASES (controller activations)')
    bounds = [(0, 'warmup/TF')]
    for col, name in (('rl_weight', 'RL'), ('physz_weight', 'physics-Z')):
        if col in df and (df[col] > 0).any():
            on = int(epoch[np.nonzero(df[col] > 0)[0][0]])
            bounds.append((on, name))
            obs.append(f'{name} activated @ {on}')
    bounds.sort()
    for i, (start, name) in enumerate(bounds):
        end = bounds[i + 1][0] - 1 if i + 1 < len(bounds) else int(epoch[-1])
        seg = (epoch >= start) & (epoch <= end)
        if not seg.any():
            continue
        ex_seg, ar_seg = df['exact_match'][seg], df['true_ar_exact'][seg]
        print(f"  [{start:4d}-{end:4d}] +{name}: exact "
              f"{ex_seg[0]:.3f}->{ex_seg[-1]:.3f}"
              f"  AR {ar_seg[0]:.3f}->"
              f"{ar_seg[-1]:.3f}"
              f"  {_nanmean(df['samples_per_s'][seg]):7.1f} samples/s")

    # -- milestones ----------------------------------------------------------
    hr('MILESTONES (first epoch exact_match crossed each level)')
    for level in (0.10, 0.25, 0.50, 0.75, 0.85, 0.90, 0.93):
        hit = np.nonzero(df['exact_match'] >= level)[0]
        if len(hit):
            i = hit[0]
            print(f"  {level:.0%}: epoch {int(epoch[i])} "
                  f"(AR {df['true_ar_exact'][i]:.3f}, lr {df['lr'][i]:.2e})")

    # -- plateaus ------------------------------------------------------------
    hr(f'PLATEAUS (<{args.plateau_threshold} gain over '
       f'{args.plateau_window} epochs)')
    ex = df['exact_match']
    w = args.plateau_window
    start = None
    plateaus = []
    for i in range(w, len(ex)):
        if ex[i] - ex[i - w] < args.plateau_threshold:
            if start is None:
                start = i - w
        elif start is not None:
            plateaus.append((start, i))
            start = None
    if start is not None:
        plateaus.append((start, len(ex) - 1))
    for s, e in plateaus[:10]:
        print(f'  epochs {int(epoch[s])}-{int(epoch[e])} at exact~{ex[s]:.3f}')

    # -- major events (sudden drops/spikes, any metric) ----------------------
    hr('MAJOR EVENTS (|delta| > 5x rolling std)')
    events = 0
    for col in ('exact_match', 'true_ar_exact', 'total', 'entropy'):
        if col not in df or n < 12:
            continue
        v = df[col]
        d = np.diff(v)
        roll = max(float(np.std(d[:max(len(d) // 2, 5)])), 1e-6)
        big = np.where(np.abs(d) > 5 * roll)[0]
        for i in big[:5]:
            print(f'  {col} @ epoch {int(epoch[i + 1])}: {v[i]:.3f} -> {v[i + 1]:.3f}')
            events += 1
    if not events:
        print('  none')
    drops = np.where(np.diff(ex) < -0.05)[0]
    for d in drops[:5]:
        obs.append(f'catastrophic exact drop @ {int(epoch[d + 1])}')

    # -- recent trend --------------------------------------------------------
    hr(f'RECENT TREND (last {args.trend_window} epochs)')
    for col in ('exact_match', 'true_ar_exact', 'total', 'lr', 'entropy', 'mean_reward'):
        if col not in df:
            continue
        v = df[col][-args.trend_window:] if args.trend_window > 0 else df[col][:0]
        if len(v) < 3:
            continue
        slope = np.polyfit(np.arange(len(v)), v, 1)[0]
        print(f'  {col:16s} {v[0]:10.4f} -> {v[-1]:10.4f}  ({slope:+.2e}/epoch)')

    # -- periodic table ------------------------------------------------------
    hr(f'EPOCH TABLE (every {args.table_every})')
    print('  epoch   exact     AR     total      lr      rl_w   samples/s')
    for i in np.nonzero(epoch % args.table_every == 0)[0]:
        rl_w = df['rl_weight'][i] if 'rl_weight' in df else 0.0
        print(f"  {int(epoch[i]):5d}  {df['exact_match'][i]:.4f}  "
              f"{df['true_ar_exact'][i]:.4f}  {df['total'][i]:8.3f}  "
              f"{df['lr'][i]:.2e}  {rl_w:6.3f}  "
              f"{df['samples_per_s'][i]:9.1f}")

    # -- correlations --------------------------------------------------------
    if 'exact_match' in df and n > 5:
        corr = _sorted_nan_last([(k, _corr(v, df['exact_match'])) for k, v in df.items()
                                 if k != 'exact_match'])
        hr('CORRELATION WITH exact_match')
        print('  most negative:', ', '.join(f'{k}={v:.2f}' for k, v in corr[:3]))
        print('  most positive:', ', '.join(f'{k}={v:.2f}' for k, v in corr[-3:]))

    hr('KEY OBSERVATIONS')
    print(f"  epochs: {n}  throughput mean "
          f"{_nanmean(df['samples_per_s']):.1f}/s  epoch time mean "
          f"{_nanmean(df['epoch_time_s']):.2f}s")
    for o in obs:
        print(f'  - {o}')


if __name__ == '__main__':
    main()
