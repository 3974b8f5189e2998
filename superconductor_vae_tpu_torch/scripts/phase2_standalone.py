"""Standalone Phase-2 self-supervised campaign on a trained checkpoint
(port of scripts/phase2_standalone.py), on the card unless ``--cpu``.

The in-loop Phase-2 sub-epoch is gated on TF exact >= 0.80; on an
order-resampled corpus that gate may stay closed even when the model is
strong on its source corpus.  This script runs the same
``SelfSupervisedEpoch`` (training/self_supervised.py) directly against a
checkpoint: build the z-cache, run N gated low-LR sub-epochs (rebuilding
the cache after each but the last), track novel discoveries, and save the
updated params as a new loadable checkpoint (optional):

    python -m superconductor_vae_tpu_torch.scripts.phase2_standalone \\
        --checkpoint outputs/checkpoints/best --sub-epochs 3 \\
        --out-dir results/phase2 [--pallas-decode]

``--checkpoint`` takes the port's format (``state.pt`` + ``meta.json``) or
an Orbax snapshot of the JAX package, as the eval CLI does; ``--params``
and ``--meta`` take an npz export of a snapshot's params and its
meta.json.  ``--save-checkpoint`` writes a
params-only checkpoint in the port's format (optimizer states dropped,
``meta.json`` the source's with a ``phase2`` summary).  It writes
``phase2_log.jsonl`` (one record a sub-epoch) and ``phase2_summary.json``
under ``--out-dir``, with the JAX CLI's keys.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument('--checkpoint', help="a checkpoint directory in the port's format")
    src.add_argument('--params', help='npz of the encoder and decoder params '
                                      '(enc_params/... and dec_params/... keys)')
    p.add_argument('--meta', default=None, help="the checkpoint's meta.json (with --params)")
    p.add_argument('--csv', default='data/processed/jarvis_merged_v2.csv.gz')
    p.add_argument('--limit', type=int, default=None,
                   help='head-slice the corpus (smoke tests)')
    p.add_argument('--sub-epochs', type=int, default=3)
    p.add_argument('--n-samples', type=int, default=256,
                   help='z samples per sub-epoch')
    p.add_argument('--phase2-weight', type=float, default=0.1)
    p.add_argument('--lr-factor', type=float, default=0.1)
    p.add_argument('--base-lr', type=float, default=3e-5)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--out-dir', default='results/phase2')
    p.add_argument('--save-checkpoint', default=None,
                   help='write the post-Phase-2 params as a loadable '
                        'checkpoint here')
    p.add_argument('--cpu', action='store_true', help='run on the CPU (default: the card)')
    p.add_argument('--pallas-decode', action='store_true',
                   help='decode the rollouts through K1, the decode-step attention '
                        'kernel (ModelConfig.pallas_decode)')
    args = p.parse_args(argv)
    if args.params and not args.meta:
        p.error('--params needs --meta')

    import torch
    from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform, save_params_checkpoint
    from superconductor_vae_tpu_torch.data import load_dataset
    from superconductor_vae_tpu_torch.generation.latent_analyzer import LatentSpaceAnalyzer
    from superconductor_vae_tpu_torch.scripts.holdout_search import load_models, read_source
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import build_luts
    from superconductor_vae_tpu_torch.training.self_supervised import (
        Phase2Config, SelfSupervisedEpoch)
    from superconductor_vae_tpu_torch.utils.device import resolve_device

    device = resolve_device('cpu' if args.cpu else 'cuda')
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    payload, meta = read_source(args)
    encoder, decoder, _ = load_models(args, device, payload, meta)
    mcfg = encoder.cfg
    tokenizer = default_tokenizer(max_len=mcfg.max_len)
    ds = load_dataset(args.csv, max_len=mcfg.max_len, tokenizer=tokenizer,
                      limit=args.limit, skew_transform=ckpt_skew_transform(meta))
    luts = build_luts(tokenizer, device=device)

    phase2 = SelfSupervisedEpoch(
        encoder, decoder, tokenizer, ds, luts,
        cfg=Phase2Config(n_samples=args.n_samples, lr_factor=args.lr_factor),
        base_lr=args.base_lr, output_dir=str(out_dir))

    generator = torch.Generator(device=device).manual_seed(args.seed)
    log_path = out_dir / 'phase2_log.jsonl'
    current_exact = float((meta.get('controllers') or {})
                          .get('last_ar_exact', 0.0)) or None

    print(f'z-cache over {len(ds)} rows ...', flush=True)
    cache = LatentSpaceAnalyzer(encoder).build_cache(ds)

    for se in range(args.sub_epochs):
        t0 = time.perf_counter()
        out = phase2.run(cache.z, generator, phase2_weight=args.phase2_weight,
                         current_exact=current_exact)
        rec = {'sub_epoch': se, 'wall_s': round(time.perf_counter() - t0, 2),
               'metrics': out['metrics']}
        with open(log_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')
        print(f'[phase2 {se}] {out["metrics"]}', flush=True)
        # refresh the z-cache after an update so later sub-epochs sample
        # the CURRENT latent geometry (the loop rebuilds it per sub-epoch)
        if se + 1 < args.sub_epochs:
            cache = LatentSpaceAnalyzer(encoder).build_cache(ds)

    tracker = phase2.tracker
    summary = {
        'checkpoint': str(args.checkpoint or args.params),
        'sub_epochs': args.sub_epochs,
        'n_samples': args.n_samples,
        'novel_discoveries': len(tracker.discoveries),
        'unique_novel': len({d['formula'] for d in tracker.discoveries}),
        'holdout_hits': list(tracker.holdout_hits),
        'log': str(log_path),
    }
    (out_dir / 'phase2_summary.json').write_text(json.dumps(summary, indent=2, default=str))
    print(json.dumps(summary, indent=2, default=str))

    if args.save_checkpoint:
        payload['enc_params'] = encoder.state_dict()
        payload['dec_params'] = decoder.state_dict()
        dst = save_params_checkpoint(args.save_checkpoint, payload,
                                     dict(meta, phase2=summary))
        print(f'saved post-Phase-2 checkpoint -> {dst}')
    return {'encoder': encoder, 'decoder': decoder, 'phase2': phase2, 'summary': summary}


if __name__ == '__main__':
    main()
