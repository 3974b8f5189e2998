"""Generation quality audit (port of scripts/generation_quality.py), on the
card unless ``--cpu``:

    python -m superconductor_vae_tpu_torch.scripts.generation_quality \\
        --checkpoint <dir> [--pallas-decode] [--limit 1024]

Decodes the corpus (its first ``--limit`` rows) autoregressively with
``TrainConfig()``'s decode gates and grades the outputs: AR and TF exact
match, the element similarity of the misses to their targets, the share
of misses that pass ``CandidateValidator``, the error taxonomy (wrong
elements, wrong subscripts, too long, too short, unparseable) and the
family accuracy.  The weights' sources and ``--pallas-decode`` are the
holdout CLI's (scripts/holdout_search.py).
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path


def classify_error(target: str, generated: str) -> str:
    from superconductor_vae_tpu_torch.data.pipeline import parse_formula_composition
    if generated == target:
        return 'exact'
    ct = parse_formula_composition(target)
    cg = parse_formula_composition(generated)
    if not cg:
        return 'unparseable'
    if set(cg) != set(ct):
        return 'wrong_elements'
    if generated.startswith(target):
        return 'too_long'
    if target.startswith(generated):
        return 'too_short'
    return 'wrong_subscripts'


def main(argv=None):
    from superconductor_vae_tpu_torch.scripts.holdout_search import (
        add_source_args, load_models, parse_source_args, print_k1_launches)
    p = argparse.ArgumentParser()
    add_source_args(p)
    p.add_argument('--csv', default='data/processed/jarvis_merged.csv.gz')
    p.add_argument('--limit', type=int, default=None)
    p.add_argument('--out', default='outputs/generation_quality.json')
    args = parse_source_args(p, argv)

    import numpy as np
    from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform
    from superconductor_vae_tpu_torch.data import load_dataset
    from superconductor_vae_tpu_torch.generation.holdout_search import element_similarity
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, evaluate_autoregressive)
    from superconductor_vae_tpu_torch.utils.device import resolve_device
    from superconductor_vae_tpu_torch.validation import CandidateValidator

    launches0 = decode_step_attention.launches
    device = resolve_device('cpu' if args.cpu else 'cuda')
    encoder, decoder, meta = load_models(args, device)
    tokenizer = default_tokenizer(max_len=decoder.cfg.max_len)
    ds = load_dataset(args.csv, max_len=decoder.cfg.max_len, tokenizer=tokenizer,
                      limit=args.limit, skew_transform=ckpt_skew_transform(meta))
    out = evaluate_autoregressive(encoder, decoder, ds, TrainConfig(),
                                  build_luts(tokenizer, device=device),
                                  tokenizer=tokenizer, collect_errors=True)

    taxonomy = Counter()
    sims = []
    validator = CandidateValidator()
    n_valid = 0
    for rec in out['error_records']:
        taxonomy[classify_error(rec['formula'], rec['generated'])] += 1
        sims.append(element_similarity(rec['generated'], rec['formula']))
        if validator.validate(rec['generated']).is_valid:
            n_valid += 1
    n_err = max(len(out['error_records']), 1)

    report = {
        'n_evaluated': out['n_evaluated'],
        'ar_exact': out['ar_exact'],
        'tf_exact': out['tf_exact'],
        'tc_mae_kelvin': out['tc_mae_kelvin'],
        'tc_r2_per_bin': out['tc_r2_per_bin'],
        'family_coarse_acc': out['family_coarse_acc'],
        'error_taxonomy': dict(taxonomy),
        'error_mean_similarity': float(np.mean(sims)) if sims else 1.0,
        'error_validity_rate': n_valid / n_err,
    }
    print(json.dumps(report, indent=2))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {**report, 'errors': out['error_records'][:200]}, indent=2))
    print_k1_launches(launches0)
    return report


if __name__ == '__main__':
    main()
