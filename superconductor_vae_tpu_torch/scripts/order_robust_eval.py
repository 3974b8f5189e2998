"""Order-robust AR evaluation (port of scripts/order_robust_eval.py): does
the model treat respelled formulas as the same material?  On the card
unless ``--cpu``:

    python -m superconductor_vae_tpu_torch.scripts.order_robust_eval \\
        --checkpoint <dir> [--pallas-decode] --limit 1024 --k 2

For a seeded SC-stratified sample of corpus rows it makes up to K random
element-order respellings of each row (``data/pipeline.py``
``_apply_order_augmentation``, the training augmentation), encodes and
greedy-decodes every respelling and every source row with the
checkpoint's decode gates, and reports:

- ``respelled_ar_exact``: a respelling decodes to its own token stream;
- ``composition_exact``: it decodes to the source row's composition
  (``canonical_composition_key``; the headline number);
- ``canonical_output_rate``: it decodes to the source row's corpus
  spelling;
- ``z_cosine_mean`` / ``z_cosine_p5``: the cosine between the source
  row's z and each respelling's (the encoder's order invariance).

The weights' sources and ``--pallas-decode`` are the holdout CLI's
(scripts/holdout_search.py).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def z_cosines(encoder, ds, rows, src_rows, batch_size: int):
    """cos(z of ``ds`` row ``rows[i]``, z of row ``src_rows[i]``) for each
    i, in batches of ``batch_size`` (the last padded with its first row, so
    every batch has one shape)."""
    import numpy as np
    import torch
    from superconductor_vae_tpu_torch.models.layers import eval_mode

    device = next(encoder.parameters()).device

    def z_of(idx):
        b = ds.batch(idx)
        with torch.no_grad(), eval_mode(encoder):
            return encoder.encode(*(torch.as_tensor(b[k], device=device) for k in (
                'element_indices', 'element_fractions', 'element_mask', 'magpie', 'tc'))
                                  )['z'].cpu().numpy()

    cos = []
    for s in range(0, len(rows), batch_size):
        r = rows[s:s + batch_size]
        pad = batch_size - len(r)
        r_p = np.concatenate([r, r[:1].repeat(pad)]) if pad else r
        s_p = np.concatenate([src_rows[s:s + batch_size], src_rows[s:s + 1].repeat(pad)]) \
            if pad else src_rows[s:s + batch_size]
        zb, zs = z_of(r_p), z_of(s_p)
        c = (zb * zs).sum(1) / np.maximum(
            np.linalg.norm(zb, axis=1) * np.linalg.norm(zs, axis=1), 1e-9)
        cos.append(c[:len(r)])
    return np.concatenate(cos)


def main(argv=None):
    from superconductor_vae_tpu_torch.scripts.holdout_search import (
        add_source_args, load_models, parse_source_args, print_k1_launches, source_name)
    p = argparse.ArgumentParser()
    add_source_args(p)
    p.add_argument('--csv', default='data/processed/jarvis_merged_v2.csv.gz')
    p.add_argument('--limit', type=int, default=1024)
    p.add_argument('--k', type=int, default=2,
                   help='respellings per row (max; single-element rows '
                        'have only one spelling)')
    p.add_argument('--sample-seed', type=int, default=0)
    p.add_argument('--respell-seed', type=int, default=12345)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--out', default=None)
    args = parse_source_args(p, argv)

    import numpy as np
    from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform
    from superconductor_vae_tpu_torch.data import load_dataset
    from superconductor_vae_tpu_torch.data.pipeline import (
        _apply_order_augmentation, canonical_composition_key)
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, eval_train_config, evaluate_autoregressive)
    from superconductor_vae_tpu_torch.utils.device import resolve_device

    launches0 = decode_step_attention.launches
    device = resolve_device('cpu' if args.cpu else 'cuda')
    encoder, decoder, meta = load_models(args, device)
    tokenizer = default_tokenizer(max_len=decoder.cfg.max_len)
    ds = load_dataset(args.csv, max_len=decoder.cfg.max_len, tokenizer=tokenizer,
                      skew_transform=ckpt_skew_transform(meta))
    base = ds.subset(ds.sample_indices(args.limit, seed=args.sample_seed, stratify_sc=True))
    aug = _apply_order_augmentation(base, tokenizer, args.k, args.respell_seed)
    n0, n_all = len(base), len(aug)
    if n_all == n0:
        print(json.dumps({'error': 'no multi-element rows to respell'}))
        return None
    resp_rows = np.arange(n0, n_all)
    src_of = aug.aug_group[resp_rows]          # the source row of each respelling

    # the training run's decode gates; a key the meta lacks keeps TrainConfig's
    tcfg = eval_train_config(decoder.cfg.max_len, meta.get('eval_gating'))
    luts = build_luts(tokenizer, device=device)

    t0 = time.perf_counter()
    out = evaluate_autoregressive(encoder, decoder, aug, tcfg, luts, tokenizer=tokenizer,
                                  batch_size=args.batch_size, collect_errors=True,
                                  sample_indices=resp_rows)
    # the source rows themselves, same slice, same gates
    out_src = evaluate_autoregressive(encoder, decoder, aug, tcfg, luts, tokenizer=tokenizer,
                                      batch_size=args.batch_size, collect_errors=True,
                                      sample_indices=np.arange(n0))
    comp_of = canonical_composition_key

    def decoded_map(res):
        return {int(r['index']): r['generated'] for r in res['error_records']}

    dec_resp, dec_src = decoded_map(out), decoded_map(out_src)
    ar = np.asarray(out['per_sample_ar_exact'])
    comp_exact = np.zeros(len(resp_rows), bool)
    canonical = np.zeros(len(resp_rows), bool)
    for j, row in enumerate(resp_rows):
        src = int(src_of[j])
        src_comp = comp_of(base.formulas[src])
        src_decoded_target = tokenizer.decode(np.asarray(base.tokens[src][1:]))
        decoded = aug.formulas[row] if ar[j] else dec_resp.get(int(row), '')
        comp_exact[j] = (src_comp is not None and decoded != ''
                         and comp_of(decoded) == src_comp)
        canonical[j] = decoded == base.formulas[src] or decoded == src_decoded_target

    src_ar = np.asarray(out_src['per_sample_ar_exact'])
    src_comp_exact = np.array([
        True if src_ar[i] else comp_of(dec_src.get(i, '')) == comp_of(base.formulas[i])
        for i in range(n0)], bool)

    cos = z_cosines(encoder, aug, resp_rows, aug.aug_group[resp_rows], args.batch_size)
    summary = {
        'checkpoint': source_name(args),
        'epoch': meta.get('epoch'),
        'slice': {'sample': 'stratified', 'seed': args.sample_seed,
                  'limit': args.limit, 'k': args.k,
                  'respell_seed': args.respell_seed},
        'n_source_rows': int(n0),
        'n_respellings': int(len(resp_rows)),
        'source_ar_exact': float(src_ar.mean()),
        'source_composition_exact': float(src_comp_exact.mean()),
        'respelled_ar_exact': float(ar.mean()),
        'composition_exact': float(comp_exact.mean()),
        'canonical_output_rate': float(canonical.mean()),
        'z_cosine_mean': float(cos.mean()),
        'z_cosine_p5': float(np.percentile(cos, 5)),
        'wall_s': round(time.perf_counter() - t0, 2),
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=2))
    print_k1_launches(launches0)
    return summary


if __name__ == '__main__':
    main()
