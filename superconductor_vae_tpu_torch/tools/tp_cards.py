#!/usr/bin/env python3
"""Tensor parallelism over NCCL on the cards of one host (four, a 2 x 2
grid, as JAX's dryrun runs its TP arm on four devices):

    python3 superconductor_vae_tpu_torch/tools/tp_cards.py

Runs ``python -m superconductor_vae_tpu_torch.scripts.dryrun_multichip N
--cuda`` (the DP arms and, at N >= 4 and even, the TP arm at tiny width),
then chip_smoke.py's TP phase at NCCL world N = torch.cuda.device_count():
two default steps at run4 width on an (N/2 x 2) grid against the
one-process step, K1 on the round trip's ranks, the greedy decode of 256
corpus rows against the whole decoder, samples/s and formulas/s of both.
Prints the card's name and power limit first; exits non-zero if a check
fails.
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from superconductor_vae_tpu_torch.ops import _build
    n = torch.cuda.device_count()
    if n < 4 or n % 2:
        print(f'tp_cards: needs an even number of cards, at least 4; this host has {n}',
              file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    _build.build('decode_attention', 'flash_attention')
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-m',
                        'superconductor_vae_tpu_torch.scripts.dryrun_multichip', str(n), '--cuda'],
                       capture_output=True, text=True, cwd=ROOT)
    print(f'dryrun_multichip {n} --cuda: rc {r.returncode} in {time.perf_counter() - t0:.1f} s',
          flush=True)
    print(r.stdout[-3000:], r.stderr[-3000:] if r.returncode else '', flush=True)
    cs.check(r.returncode == 0, 'dryrun_multichip --cuda failed')
    _, batches = cs.data_phase(torch, dev)
    t0 = time.perf_counter()
    launches = cs.tp_phase(torch, dev, batches, world=n, backend='nccl')
    print(f'tp phase (nccl world {n}) {time.perf_counter() - t0:.1f} s, K1 launches {launches}',
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
