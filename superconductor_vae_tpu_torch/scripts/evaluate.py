"""Checkpoint evaluation CLI (port of scripts/evaluate.py).

True-AR and TF exact match, Tc error, SC and family metrics of a checkpoint
over a corpus, on the card unless ``--cpu``:

    python -m superconductor_vae_tpu_torch.scripts.evaluate \\
        --params build/run4_params.npz \\
        --meta results/run4/ckpt_snapshot/meta.json

The weights come from a checkpoint in the port's format (``--checkpoint``)
or, since an Orbax snapshot cannot be read without tensorstore, from an
npz export of its params (``--params``, ``checkpoint/from_jax.py``
``load_params_npz``) with the ``meta.json`` beside the snapshot
(``--meta``); the meta gives the architecture, the decode gates
(``eval_gating``) and the corpus normalisation (``ckpt_skew_transform``).
The flags and the summary's keys are otherwise those of the JAX package's
CLI, whose ``--checkpoint`` takes an Orbax snapshot.
``--speculative`` builds an n-gram draft from the evaluated rows' token
stream (BOS in column 0) and decodes with speculative chunk verification
(pure greedy, no decode gates); its chunk forward needs the plain cache
layout, so ``--speculative --pallas-decode`` is refused.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    from superconductor_vae_tpu_torch.scripts.holdout_search import (
        add_source_args, load_models, parse_source_args, source_name)
    p = argparse.ArgumentParser()
    add_source_args(p)
    p.add_argument('--csv',
                   default='data/processed/jarvis_merged.csv.gz')
    p.add_argument('--limit', type=int, default=None)
    p.add_argument('--sample', choices=['head', 'random', 'stratified'],
                   default='stratified',
                   help='how --limit selects rows: seeded random, '
                        'is_sc-stratified 50/50 (default), or the CSV head '
                        'slice')
    p.add_argument('--sample-seed', type=int, default=0)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--max-batches', type=int, default=None,
                   help='default: the whole corpus')
    p.add_argument('--errors-out', default=None,
                   help='write per-sample error records JSONL here')
    p.add_argument('--out', default=None, help='write summary JSON here')
    p.add_argument('--speculative', action='store_true',
                   help='decode with the n-gram-draft speculative verifier '
                        '(pure greedy, no decode gates) instead of the '
                        'gated KV-cache scan')
    args = parse_source_args(p, argv)
    if args.speculative and args.pallas_decode:
        p.error('--speculative --pallas-decode: the speculative chunk forward needs the '
                'plain [L, B, T, H, Dh] cache layout, not the decode-step kernel\'s')

    import numpy as np
    from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform
    from superconductor_vae_tpu_torch.data import load_dataset
    from superconductor_vae_tpu_torch.models.draft import build_ngram_draft
    from superconductor_vae_tpu_torch.tokenizer import BOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, eval_train_config, evaluate_autoregressive)
    from superconductor_vae_tpu_torch.utils.device import resolve_device

    device = resolve_device('cpu' if args.cpu else 'cuda')
    encoder, decoder, meta = load_models(args, device)
    mcfg = decoder.cfg
    tokenizer = default_tokenizer(max_len=mcfg.max_len)
    head_limit = args.limit if args.sample == 'head' else None
    ds = load_dataset(args.csv, max_len=mcfg.max_len, tokenizer=tokenizer,
                      limit=head_limit, skew_transform=ckpt_skew_transform(meta))
    slice_provenance = {'sample': 'full', 'seed': None}
    if args.limit is not None and args.sample != 'head':
        print(f'# note: --limit {args.limit} uses {args.sample!r} sampling '
              f'(seed {args.sample_seed}), not the head slice', file=sys.stderr)
        idx = ds.sample_indices(args.limit, seed=args.sample_seed,
                                stratify_sc=(args.sample == 'stratified'))
        ds = ds.subset(idx)
        slice_provenance = {'sample': args.sample, 'seed': args.sample_seed}
    elif args.limit is not None:
        slice_provenance = {'sample': 'head', 'seed': None}
    # the training run's decode gates; a key the meta lacks keeps
    # TrainConfig's default
    tcfg = eval_train_config(mcfg.max_len, meta.get('eval_gating'))
    luts = build_luts(tokenizer, device=device)

    spec_tables = None
    if args.speculative:
        stream = np.concatenate([np.full((len(ds), 1), BOS_ID, np.int64),
                                 ds.tokens.astype(np.int64)[:, 1:]], axis=1)
        spec_tables = build_ngram_draft(stream, tokenizer)

    t0 = time.perf_counter()
    out = evaluate_autoregressive(
        encoder, decoder, ds, tcfg, luts, tokenizer=tokenizer,
        batch_size=args.batch_size, max_batches=args.max_batches,
        collect_errors=args.errors_out is not None, speculative_tables=spec_tables)
    wall_s = time.perf_counter() - t0

    summary = {
        'checkpoint': source_name(args),
        'epoch': meta.get('epoch'),
        'decode_path': ('speculative' if args.speculative
                        else 'k1' if args.pallas_decode else 'plain'),
        'slice': dict(slice_provenance, limit=args.limit),
        'eval_wall_s': round(wall_s, 2),
        'formulas_per_s': round(out['n_evaluated'] / max(wall_s, 1e-9), 1),
        'n_evaluated': int(out['n_evaluated']),
        'true_ar_exact': float(out['ar_exact']),
        'tf_exact': float(out['tf_exact']),
        'tc_mae_kelvin': float(out['tc_mae_kelvin']),
        'tc_r2_per_bin': out['tc_r2_per_bin'],
        'sc_metrics': out.get('sc_metrics', {}),
        'family_coarse_acc': float(out['family_coarse_acc']),
        'z_norm_mean': float(out['z_norm_mean']),
    }
    print(json.dumps(summary, indent=2))
    if args.errors_out:
        Path(args.errors_out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.errors_out, 'w') as f:
            for rec in out.get('error_records', []):
                f.write(json.dumps(rec) + '\n')
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == '__main__':
    main()
