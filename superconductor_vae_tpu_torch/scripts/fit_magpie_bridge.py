"""Fit the native-78-dim -> reference-Magpie-layout linear bridge (port of
scripts/fit_magpie_bridge.py).

Bridges the featurizer split between the reference corpus (matminer
Magpie, 145/151 columns) and the repo's matminer-free descriptor
(chem/featurize.py, 78 columns), so that converted reference checkpoints
can be evaluated or fine-tuned on natively featurized corpora:

    python -m superconductor_vae_tpu_torch.scripts.fit_magpie_bridge \\
        --ref-csv <reference-layout corpus.csv> --out data/magpie_bridge.npz
    python - <<'PY'
    from superconductor_vae_tpu_torch.data import load_dataset
    ds = load_dataset('data/processed/jarvis_merged.csv.gz',
                      magpie_bridge='data/magpie_bridge.npz')
    PY

The CSV is read with the data pipeline's standard-library reader (no
pandas).  The reference corpus is not in the repo, so ``--ref-csv`` has
no default.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ref-csv', required=True,
                   help='a corpus CSV with the reference Magpie columns')
    p.add_argument('--out', default='data/magpie_bridge.npz')
    p.add_argument('--limit', type=int, default=None)
    args = p.parse_args(argv)

    from superconductor_vae_tpu_torch.chem.featurize import fit_magpie_bridge

    b = fit_magpie_bridge(args.ref_csv, out_path=args.out, limit=args.limit)
    r2 = b['r2']
    print(f'bridge: {b["w"].shape[0] - 1} -> {b["w"].shape[1]} columns')
    print(f'R2 mean={r2.mean():.3f} median={np.median(r2):.3f} '
          f'(>0.5: {(r2 > 0.5).sum()}/{len(r2)})')
    print(f'saved {args.out}')
    return b


if __name__ == '__main__':
    main()
