"""Crash- and hang-resilient training wrapper (port of
scripts/train_resilient.py): relaunches the port's training CLI with
``--resume auto``.

- crash: the child exits nonzero -> relaunch with ``--resume auto``;
- hang: the run's ``training_metrics.csv`` has not been written for longer
  than ``--stall-timeout`` seconds -> kill the child, relaunch with resume.

The training loop saves an 'interrupt' checkpoint on SIGINT and SIGTERM
and a periodic one on its cadence; ``--resume auto`` picks the newest, and
the resumed run repeats an uninterrupted one from there.

    python -m superconductor_vae_tpu_torch.scripts.train_resilient \\
        --stall-timeout 900 -- --epochs 1000 --output outputs/run ...

Everything after ``--`` goes to ``superconductor_vae_tpu_torch.scripts.train``
(on the card unless it includes ``--cpu``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

POLL_S = 15.0           # seconds between looks at the child and its CSV
TRAIN_CMD = [sys.executable, '-m', 'superconductor_vae_tpu_torch.scripts.train']


def _metrics_path(train_args: Sequence[str]) -> Path:
    out = 'outputs'
    for i, a in enumerate(train_args):
        if a == '--output' and i + 1 < len(train_args):
            out = train_args[i + 1]
        elif a.startswith('--output='):
            out = a.split('=', 1)[1]
    return Path(out) / 'training_metrics.csv'


def main(argv: Optional[List[str]] = None, train_cmd: Sequence[str] = TRAIN_CMD) -> int:
    """Runs ``train_cmd`` + the arguments after ``--`` until it exits 0 or
    ``--max-restarts`` relaunches are spent; returns 0 or 1."""
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--max-restarts', type=int, default=20)
    p.add_argument('--cooldown', type=float, default=30.0,
                   help='seconds to wait before a relaunch')
    p.add_argument('--stall-timeout', type=float, default=1200.0,
                   help='kill and relaunch if training_metrics.csv has not been '
                        'written for this many seconds (0 = never). Must exceed '
                        'the slowest epoch with its eval and checkpoint')
    args, train_args = p.parse_known_args(argv)
    if train_args and train_args[0] == '--':
        train_args = train_args[1:]

    metrics = _metrics_path(train_args)
    base = list(train_cmd) + train_args
    for attempt in range(args.max_restarts + 1):
        cmd = list(base)
        if attempt > 0 and '--resume' not in cmd:
            cmd += ['--resume', 'auto']
        print(f'[resilient] attempt {attempt}: {" ".join(cmd)}', flush=True)
        child = subprocess.Popen(cmd)
        start = time.time()
        stalled = False
        while True:
            rc = child.poll()
            if rc is not None:
                break
            if args.stall_timeout > 0:
                try:
                    last = metrics.stat().st_mtime
                except OSError:
                    last = start          # no CSV yet: count from the launch
                if time.time() - max(last, start) > args.stall_timeout:
                    print(f'[resilient] STALL: no metrics progress for '
                          f'{args.stall_timeout:.0f}s; killing child', flush=True)
                    child.kill()
                    child.wait()
                    rc, stalled = -1, True
                    break
            time.sleep(POLL_S)
        if rc == 0:
            print('[resilient] finished cleanly', flush=True)
            return 0
        why = 'stalled' if stalled else f'exited rc={rc}'
        print(f'[resilient] {why}; relaunching after cooldown', flush=True)
        time.sleep(args.cooldown)
    print('[resilient] giving up after max restarts', flush=True)
    return 1


if __name__ == '__main__':
    sys.exit(main())
