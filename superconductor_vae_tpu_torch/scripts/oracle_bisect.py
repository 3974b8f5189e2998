"""Oracle-reconstruction bisect (port of scripts/oracle_bisect.py), on the
card unless ``--cpu``:

    python -m superconductor_vae_tpu_torch.scripts.oracle_bisect \\
        --checkpoint <dir> [--pallas-decode] --n 128

Sends N random training formulas through the fresh-formula oracle path of
the holdout targets (``HoldoutSearch.oracle_encode_latent``: re-parse,
alphabetical slots, normalised fractions, fresh Magpie through the
persisted quantile grids, known Tc, encode) and a greedy decode, and
reports the share that reconstruct exactly at composition level
(``train_oracle_exact``) with up to 20 misses.  If training rows
reconstruct at about the AR exact rate, the oracle path is sound and a
low holdout number is the train-to-holdout gap.  The weights' sources
and ``--pallas-decode`` are the holdout CLI's (scripts/holdout_search.py).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None):
    from superconductor_vae_tpu_torch.scripts.holdout_search import (
        add_source_args, build_pipeline, parse_source_args, print_k1_launches, source_name)
    p = argparse.ArgumentParser()
    add_source_args(p)
    p.add_argument('--csv', default='data/processed/jarvis_merged_v2.csv.gz')
    p.add_argument('--n', type=int, default=128)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--out', default=None)
    args = parse_source_args(p, argv)

    import numpy as np
    from superconductor_vae_tpu_torch.data.pipeline import canonical_composition_key
    from superconductor_vae_tpu_torch.generation.holdout_search import HoldoutSearch
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention

    launches0 = decode_step_attention.launches
    pipe, meta = build_pipeline(args)
    search = HoldoutSearch(pipe)
    ds = pipe.ds

    rng = np.random.default_rng(args.seed)
    sel = rng.choice(len(ds), size=min(args.n, len(ds)), replace=False)
    n_ok = n_enc = 0
    misses = []
    for i in sel:
        f = ds.formulas[int(i)]
        zo = search.oracle_encode_latent(f)
        if zo is None:
            continue
        n_enc += 1
        dec = pipe.decode_latents(zo, temperature=0.0)
        d = dec[0] if dec else ''
        ok = canonical_composition_key(d) == canonical_composition_key(f)
        n_ok += bool(ok)
        if not ok and len(misses) < 20:
            misses.append({'formula': f, 'decoded': d})
    summary = {
        'checkpoint': source_name(args),
        'epoch': meta.get('epoch'),
        'n_requested': args.n, 'n_encoded': n_enc,
        'train_oracle_exact': n_ok / max(n_enc, 1),
        'seed': args.seed,
        'sample_misses': misses,
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=2))
    print_k1_launches(launches0)
    return summary


if __name__ == '__main__':
    main()
