"""Holdout generative search CLI (port of scripts/holdout_search.py), on
the card unless ``--cpu``:

    python -m superconductor_vae_tpu_torch.scripts.holdout_search \\
        --checkpoint outputs/checkpoints/best --budget 200 [--pallas-decode]

``--checkpoint`` takes the port's format (``state.pt`` + ``meta.json``);
``--params`` and ``--meta`` take an npz export of a JAX snapshot's params
and its meta.json, as the eval CLI does.  The corpus defaults to the
repo's ``data/processed/jarvis_merged.csv.gz``, normalised as the
checkpoint was trained (``ckpt_skew_transform``).  The other flags, the
JSON written to ``--out`` and the ``--stream`` lines are the JAX CLI's;
``--pallas-decode`` decodes through K1, the decode-step attention kernel.
``--oracle-only`` skips the search and greedy-decodes each target's direct
encoding (holdout reconstruction).  The last line printed gives K1's
launches in the run (``K1_LINE``; 0 without ``--pallas-decode``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    add_source_args(p)
    p.add_argument('--csv', default='data/processed/jarvis_merged.csv.gz')
    p.add_argument('--budget', type=int, default=200)
    p.add_argument('--refine-rounds', type=int, default=2,
                   help='zoom-in sweeps around the best candidate')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--n-targets', type=int, default=None)
    p.add_argument('--target-offset', type=int, default=0,
                   help='start at this absolute holdout index (split long '
                        'campaigns across processes; a target\'s random '
                        'streams are the same as in one run)')
    p.add_argument('--no-guided', action='store_true',
                   help='disable head-guided latent optimization')
    p.add_argument('--no-inverse', action='store_true',
                   help='disable local inverse-regression queries')
    p.add_argument('--no-inversion', action='store_true',
                   help='disable direct decoder inversion (TF-CE gradient '
                        'descent on z toward the exact target sequence)')
    p.add_argument('--inversion-starts', type=int, default=24)
    p.add_argument('--inversion-steps', type=int, default=384)
    p.add_argument('--guided-starts', type=int, default=16)
    p.add_argument('--constrain-elements', action='store_true',
                   help='restrict decode to the target element set '
                        '(extended capability mode; NOT comparable to the '
                        'reference holdout protocol)')
    p.add_argument('--decode-chunk', type=int, default=2048,
                   help='fixed decode batch (bounds KV-cache memory)')
    p.add_argument('--sample-slice', type=int, default=4096,
                   help='leading pool rows decoded at sampled temperatures')
    p.add_argument('--sample-draws', type=int, default=2)
    p.add_argument('--skew-transform', default=None,
                   choices=['rank_gauss', 'quantile'],
                   help='override the corpus Magpie skew transform '
                        '(default: what the checkpoint trained under)')
    p.add_argument('--no-snap-stoich', action='store_true',
                   help='disable the rational snap of predicted stoich '
                        'conditioning before decode (generation/stoich_snap.py)')
    p.add_argument('--no-oracle', action='store_true',
                   help='skip the per-target oracle-reconstruction diagnostic')
    p.add_argument('--oracle-only', action='store_true',
                   help='skip the generative search: encode each holdout '
                        'composition directly (alphabetical slots, fresh '
                        'Magpie, known Tc) and greedy-decode (the holdout '
                        'RECONSTRUCTION number, oracle_match/45)')
    p.add_argument('--strategy-order', default='tiered',
                   choices=['tiered', 'inversion_first'],
                   help="'tiered' runs navigation -> guided -> inversion so "
                        'exact matches are attributed to the weakest '
                        "information budget that lands them; 'inversion_first' "
                        'is the legacy speed ordering')
    p.add_argument('--out', default='outputs/holdout_results.json')
    p.add_argument('--stream', default=None,
                   help='append each finished target to this JSONL as it '
                        'completes (survives a mid-campaign kill)')
    return p


K1_LINE = '[k1] decode_step_attention launches:'


def add_source_args(p: argparse.ArgumentParser) -> None:
    """The weights' sources and the device flags that every decoding CLI
    of the port takes: ``--checkpoint`` or ``--params`` with ``--meta``,
    ``--cpu`` and ``--pallas-decode``."""
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument('--checkpoint', help="a checkpoint directory in the port's format")
    src.add_argument('--params', help='npz of the encoder and decoder params '
                                      '(enc_params/... and dec_params/... keys)')
    p.add_argument('--meta', default=None, help="the checkpoint's meta.json (with --params)")
    p.add_argument('--cpu', action='store_true', help='run on the CPU (default: the card)')
    p.add_argument('--pallas-decode', action='store_true',
                   help='decode through K1, the decode-step attention kernel '
                        '(ModelConfig.pallas_decode)')


def parse_source_args(p: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """``p``'s arguments; ``--params`` without ``--meta`` is an error."""
    args = p.parse_args(argv)
    if args.params and not args.meta:
        p.error('--params needs --meta')
    return args


def print_k1_launches(launches0: int) -> int:
    """Prints the decode-step kernel's launches since ``launches0`` on a
    line of its own (a campaign driver's subprocesses report theirs so);
    returns them."""
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    n = decode_step_attention.launches - launches0
    print(f'{K1_LINE} {n}', flush=True)
    return n


def load_models(args, device):
    """(encoder, decoder, meta) in eval mode from ``--checkpoint`` or
    ``--params`` / ``--meta``."""
    from superconductor_vae_tpu_torch.checkpoint import (
        load_checkpoint, load_params_npz, params_from_jax)
    from superconductor_vae_tpu_torch.models import (
        FormulaDecoder, MaterialsEncoder, config_from_meta)
    if args.checkpoint:
        restored, meta = load_checkpoint(args.checkpoint)
    else:
        meta = json.loads(Path(args.meta).read_text())
    mcfg = config_from_meta(meta['model_config'], pallas_decode=args.pallas_decode)
    if args.checkpoint:
        encoder = MaterialsEncoder(mcfg, device=device)
        decoder = FormulaDecoder(mcfg, device=device)
        encoder.load_state_dict(restored['enc_params'])
        decoder.load_state_dict(restored['dec_params'])
    else:
        trees = load_params_npz(args.params)
        encoder, decoder = params_from_jax(trees['enc_params'], trees['dec_params'], mcfg,
                                           device=device)
    return encoder.eval(), decoder.eval(), meta


def source_name(args) -> str:
    """The checkpoint a run read: ``--checkpoint``, or ``--meta``'s directory."""
    return str(args.checkpoint) if args.checkpoint else str(Path(args.meta).parent)


def build_pipeline(args, skew_transform=None):
    """(SuperconductorDiscoveryPipeline, meta) of the CLI's weights on its
    device, over ``--csv`` normalised as the checkpoint was trained."""
    from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform
    from superconductor_vae_tpu_torch.data import load_dataset
    from superconductor_vae_tpu_torch.generation import SuperconductorDiscoveryPipeline
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.utils.device import resolve_device

    device = resolve_device('cpu' if args.cpu else 'cuda')
    encoder, decoder, meta = load_models(args, device)
    tokenizer = default_tokenizer(max_len=decoder.cfg.max_len)
    ds = load_dataset(args.csv, max_len=decoder.cfg.max_len, tokenizer=tokenizer,
                      skew_transform=skew_transform or ckpt_skew_transform(meta))
    return SuperconductorDiscoveryPipeline(encoder, decoder, tokenizer, ds,
                                           type_masks=tokenizer.type_masks), meta


def main(argv=None):
    args = parse_source_args(build_parser(), argv)

    from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform
    from superconductor_vae_tpu_torch.data.pipeline import canonical_composition_key
    from superconductor_vae_tpu_torch.generation.holdout_search import HoldoutSearch
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention

    launches0 = decode_step_attention.launches
    pipe, meta = build_pipeline(args, args.skew_transform)
    skew = args.skew_transform or ckpt_skew_transform(meta)
    search = HoldoutSearch(pipe)
    lo = args.target_offset
    hi = lo + args.n_targets if args.n_targets else len(search.targets)
    targets = search.targets[lo:hi] if (lo, hi) != (0, len(search.targets)) else None
    stream_fn = None
    if args.stream:
        stream_path = Path(args.stream)
        stream_path.parent.mkdir(parents=True, exist_ok=True)

        def stream_fn(idx, result):
            with stream_path.open('a') as fh:
                fh.write(json.dumps(
                    {'index': idx, 'seed': args.seed, 'budget': args.budget,
                     'strategy_order': args.strategy_order,
                     **dataclasses.asdict(result)}) + '\n')

    out_path = Path(args.out)
    if args.oracle_only:
        rows = []
        for t in (targets or search.targets):
            # the in-search oracle's mask convention (element-constrained;
            # the oracle's information budget holds the full composition)
            res = search.oracle_reconstruct(t, type_masks=search._element_type_masks(t))
            rec = {'target': t, 'oracle_formula': None, 'oracle_match': False,
                   'oracle_masks': 'element-constrained'}
            if res is not None:
                f0 = res[0]
                tkey = canonical_composition_key(t)
                rec['oracle_formula'] = f0
                rec['oracle_match'] = bool(tkey is not None and f0
                                           and canonical_composition_key(f0) == tkey)
            rows.append(rec)
            print(f"{t}: {rec['oracle_formula']!r} "
                  f"{'MATCH' if rec['oracle_match'] else ''}", flush=True)
        summary = {'n_targets': len(rows),
                   'oracle_match': sum(r['oracle_match'] for r in rows),
                   'skew_transform': skew}
        print(json.dumps(summary, indent=2))
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({'summary': summary, 'results': rows}, indent=2))
        print_k1_launches(launches0)
        return {'summary': summary, 'results': rows}

    results = search.search(budget_per_target=args.budget, targets=targets,
                            target_offset=lo, stream_fn=stream_fn,
                            refine_rounds=args.refine_rounds,
                            guided=not args.no_guided,
                            guided_starts=args.guided_starts,
                            inversion=not args.no_inversion,
                            inversion_starts=args.inversion_starts,
                            inversion_steps=args.inversion_steps,
                            inverse_regression=not args.no_inverse,
                            constrain_elements=args.constrain_elements,
                            decode_chunk=args.decode_chunk,
                            sample_slice=args.sample_slice,
                            sample_draws=args.sample_draws,
                            strategy_order=args.strategy_order,
                            snap_stoich=not args.no_snap_stoich,
                            oracle_diagnostic=not args.no_oracle,
                            seed=args.seed)
    summary = HoldoutSearch.summarize(results)
    print(json.dumps(summary, indent=2))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({
        'summary': summary,
        'results': [r.__dict__ for r in results],
    }, indent=2))
    print_k1_launches(launches0)
    return {'summary': summary, 'results': results}


if __name__ == '__main__':
    main()
