"""Checkpoint migration CLI (port of scripts/migrate_checkpoint.py), on the
port's checkpoint format (``state.pt`` + ``meta.json``, checkpoint/io.py);
host only:

    # grow the decoder's vocab (isotope rows start from their elements)
    python -m superconductor_vae_tpu_torch.scripts.migrate_checkpoint \\
        expand-vocab outputs/checkpoints/best --new-vocab 4800 --out outputs/expanded
    # add decoder layers (identity-initialised, function preserving)
    ... deepen outputs/checkpoints/best --layers 2 --out outputs/deeper
    # widen the whole decoder (function preserving, integer factor)
    ... widen outputs/checkpoints/best --d-model 1152 --out outputs/wider
    # widen the whole encoder (function preserving, integer factor)
    ... widen-encoder outputs/checkpoints/best --factor 2 --out outputs/wider-enc

Each writes a params-only checkpoint (``enc_params``, ``dec_params`` and
the source's ``set_params`` and ``pz_params`` where it has them; step 0,
no optimizer state) to ``<out>/<tag>``, the tag naming the surgery as
the JAX CLI names it; ``load_checkpoint``, the eval CLIs and ``train()``
with ``--resume <dir>`` and the new config read it.  Its ``meta.json``
keeps the source's epoch and, unlike the JAX CLI (which writes
``TrainConfig()``'s), the source's ``eval_gating`` and ``data_norm``, so
that the migrated model decodes and reads the corpus as the source did.
``from-torch`` (a reference PyTorch checkpoint) needs
checkpoint/torch_convert.py, which the port does not have yet: it refuses.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest='cmd', required=True)

    t = sub.add_parser('from-torch')
    t.add_argument('checkpoint')
    t.add_argument('--out', required=True)

    e = sub.add_parser('expand-vocab')
    e.add_argument('checkpoint')
    e.add_argument('--new-vocab', type=int, required=True)
    e.add_argument('--out', required=True)

    d = sub.add_parser('deepen')
    d.add_argument('checkpoint')
    d.add_argument('--layers', type=int, default=1)
    d.add_argument('--out', required=True)

    we = sub.add_parser('widen-encoder')
    we.add_argument('checkpoint')
    we.add_argument('--factor', type=int, default=2,
                    help='integer widening factor for fusion_dim and both '
                         'hidden stacks')
    we.add_argument('--noise', type=float, default=0.0)
    we.add_argument('--out', required=True)

    w = sub.add_parser('widen')
    w.add_argument('checkpoint')
    w.add_argument('--d-model', type=int, required=True,
                   help='new d_model (integer multiple of the old)')
    w.add_argument('--ffn', type=int, default=None,
                   help='new dim_feedforward (default: scale with d_model)')
    w.add_argument('--noise', type=float, default=0.0,
                   help='symmetry-breaking noise on duplicated units')
    w.add_argument('--out', required=True)
    return p


def main(argv=None) -> Path:
    args = build_parser().parse_args(argv)
    if args.cmd == 'from-torch':
        sys.exit('migrate_checkpoint from-torch: converting a reference PyTorch '
                 'checkpoint needs checkpoint/torch_convert.py, which the port does not '
                 'have yet (ROADMAP A.16)')

    from superconductor_vae_tpu_torch.checkpoint import (
        build_manifest, load_checkpoint, save_params_checkpoint)
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.models import surgery
    from superconductor_vae_tpu_torch.training import TrainConfig

    restored, meta = load_checkpoint(args.checkpoint)
    mcfg = config_from_meta(meta['model_config'])
    enc, dec = restored['enc_params'], restored['dec_params']

    if args.cmd == 'expand-vocab':
        from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
        pmap = surgery.isotope_parent_map(default_tokenizer(max_len=mcfg.max_len))
        dec = surgery.expand_decoder_vocab(dec, args.new_vocab, parent_map=pmap)
        mcfg2 = dataclasses.replace(mcfg, vocab_size=args.new_vocab)
        tag = 'vocab-expanded'
    elif args.cmd == 'deepen':
        dec = surgery.deepen_decoder(dec, args.layers)
        mcfg2 = dataclasses.replace(mcfg, num_layers=mcfg.num_layers + args.layers)
        tag = f'deepened+{args.layers}'
    elif args.cmd == 'widen':
        new_ffn = args.ffn or mcfg.dim_feedforward * args.d_model // mcfg.d_model
        dec = surgery.expand_decoder_width(dec, mcfg, args.d_model, new_ffn, noise=args.noise)
        mcfg2 = surgery.widened_config(mcfg, args.d_model, new_ffn)
        tag = f'widened-{args.d_model}'
    else:
        k = args.factor
        neh = tuple(w * k for w in mcfg.encoder_hidden)
        ndh = tuple(w * k for w in mcfg.decoder_hidden)
        enc = surgery.expand_encoder_widths(enc, mcfg, mcfg.fusion_dim * k, neh, ndh,
                                            noise=args.noise)
        mcfg2 = surgery.widened_encoder_config(mcfg, mcfg.fusion_dim * k, neh, ndh)
        tag = f'encoder-widened-x{k}'

    payload = {'step': 0, 'enc_params': enc, 'dec_params': dec}
    for group in ('set_params', 'pz_params'):
        if group in restored:
            payload[group] = restored[group]
    meta2 = {'epoch': int(meta.get('epoch', 0)), 'metrics': {},
             'model_config': dataclasses.asdict(mcfg2),
             'manifest': build_manifest(mcfg2, TrainConfig()), 'controllers': {}}
    for key in ('eval_gating', 'data_norm'):
        if key in meta:
            meta2[key] = meta[key]
    path = save_params_checkpoint(Path(args.out) / tag, payload, meta2)
    print(f'{tag} -> {path}')
    return path


if __name__ == '__main__':
    main()
