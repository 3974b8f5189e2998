"""Physics-Z coordinate analysis of a trained latent space (port of
scripts/analyze_physics_z.py):

    python -m superconductor_vae_tpu_torch.scripts.analyze_physics_z \\
        outputs/<run>/latent_cache.npz
    python -m superconductor_vae_tpu_torch.scripts.analyze_physics_z \\
        --checkpoint <dir> [--cpu] --csv data/processed/jarvis_merged.csv.gz

Reads the training run's latent cache (z and Tc in Kelvin, written on the
eval cadence by ``train()``), or encodes the corpus's first
``--n-samples`` rows from a checkpoint (on the card unless ``--cpu``),
and prints, for each block of ``models/physics_z.py`` ``BLOCKS``, its
statistics, its near-constant coordinates (std < 0.01) and its largest
correlation with log Tc over the SC rows; then the top-k Tc-correlated
coordinates of each supervised block and the variance split between the
supervised prefix and the discovery block.  The printed table is the
JAX script's, character for character.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def load_from_cache(path):
    from superconductor_vae_tpu_torch.utils.npz import as_f32
    blob = np.load(path)
    return (as_f32(blob['z']), as_f32(blob['tc_kelvin']),
            blob['is_sc'].astype(bool), blob['family'])


def load_by_encoding(args):
    import torch
    from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform
    from superconductor_vae_tpu_torch.data import load_dataset
    from superconductor_vae_tpu_torch.models.layers import eval_mode
    from superconductor_vae_tpu_torch.scripts.holdout_search import load_models
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.utils.device import resolve_device

    device = resolve_device('cpu' if args.cpu else 'cuda')
    encoder, decoder, meta = load_models(args, device)
    max_len = decoder.cfg.max_len
    ds = load_dataset(args.csv, max_len=max_len, tokenizer=default_tokenizer(max_len=max_len),
                      skew_transform=ckpt_skew_transform(meta))
    b = ds.batch(np.arange(min(args.n_samples, len(ds))))
    with torch.no_grad(), eval_mode(encoder):
        z = encoder.encode(*(torch.as_tensor(b[k], device=device) for k in (
            'element_indices', 'element_fractions', 'element_mask', 'magpie', 'tc')))['z']
    return (z.cpu().numpy(), ds.norm_stats.tc_to_kelvin(b['tc']), b['is_sc'].astype(bool),
            b['family'])


def _tc_correlation(blk: np.ndarray, log_tc: np.ndarray) -> np.ndarray:
    """Each column's correlation with ``log_tc``."""
    bc = blk - blk.mean(0)
    tcc = log_tc - log_tc.mean()
    return (bc.T @ tcc) / (np.linalg.norm(bc, axis=0) * np.linalg.norm(tcc) + 1e-12)


def block_stats(z: np.ndarray, tc_k: np.ndarray, is_sc: np.ndarray,
                top_k: int = 5) -> Dict:
    """The analysis as data: ``blocks`` {name: (start, end, mean, std,
    mean per-coordinate variance, near-constant count, max |r(log Tc)|)},
    ``top`` {name: [(coordinate, r)]} for the supervised blocks with more
    than 8 SC rows, and the variance split ``(sup_end, var_sup,
    var_disc)``."""
    from superconductor_vae_tpu_torch.models.physics_z import BLOCKS
    log_tc = np.log1p(np.clip(tc_k, 0, None))
    blocks, top = {}, {}
    for name, (s, e) in BLOCKS.items():
        blk = z[:, s:e]
        n_const = int((blk.std(axis=0) < 0.01).sum())
        sc_blk = blk[is_sc]
        r = _tc_correlation(sc_blk, log_tc[is_sc]) if len(sc_blk) > 8 else np.zeros(e - s)
        blocks[name] = (s, e, blk.mean(), blk.std(), blk.var(0).mean(), n_const,
                        np.abs(r).max())
        if name != 'discovery' and len(sc_blk) > 8:
            order = np.argsort(-np.abs(r))[:top_k]
            top[name] = [(s + int(i), r[i]) for i in order]
    sup_end = max(e for k, (s, e) in BLOCKS.items() if k != 'discovery')
    return {'blocks': blocks, 'top': top,
            'variance': (sup_end, z[:, :sup_end].var(0).sum(), z[:, sup_end:].var(0).sum())}


def report(z, tc_k, is_sc, top_k: int = 5) -> None:
    stats = block_stats(z, tc_k, is_sc, top_k)
    print(f'z: {z.shape}  global mean={z.mean():.4f} std={z.std():.4f} '
          f'min={z.min():.3f} max={z.max():.3f}')
    print(f'SC fraction: {is_sc.mean():.3f}   Tc range: '
          f'{tc_k.min():.1f}-{tc_k.max():.1f} K')
    print()
    print(f"{'block':<14}{'range':<12}{'mean':>8}{'std':>8}"
          f"{'x-var':>9}{'const':>7}{'|r(Tc)|max':>11}")
    print('-' * 69)
    for name, (s, e, mean, std, xvar, n_const, rmax) in stats['blocks'].items():
        print(f'{name:<14}{f"[{s}:{e}]":<12}{mean:>8.3f}'
              f'{std:>8.3f}{xvar:>9.4f}'
              f'{n_const:>5}/{e - s:<3}{rmax:>9.3f}')
    print()
    print(f'top {top_k} Tc-correlated coordinates per supervised block:')
    for name, coords in stats['top'].items():
        print(f'  {name:<14}' + ', '.join(f'z[{i}]={r:+.2f}' for i, r in coords))
    sup_end, var_sup, var_disc = stats['variance']
    print()
    print(f'variance split: supervised z[:{sup_end}] {var_sup:.1f}  vs  '
          f'discovery z[{sup_end}:] {var_disc:.1f} '
          f'({var_disc / (var_sup + var_disc + 1e-9):.1%} in discovery space)')


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('cache', nargs='?', default=None,
                   help='latent_cache.npz from a training run')
    src = p.add_mutually_exclusive_group()
    src.add_argument('--checkpoint', default=None, help="a checkpoint in the port's format")
    src.add_argument('--params', default=None, help='npz of the params (with --meta)')
    p.add_argument('--meta', default=None)
    p.add_argument('--csv', default='data/processed/jarvis_merged.csv.gz')
    p.add_argument('--n-samples', type=int, default=4096)
    p.add_argument('--cpu', action='store_true', help='encode on the CPU (default: the card)')
    p.add_argument('--top-k', type=int, default=5,
                   help='top Tc-correlated coordinates to list per block')
    args = p.parse_args(argv)
    args.pallas_decode = False          # the encoder alone: no decode
    if args.cache:
        z, tc_k, is_sc, _ = load_from_cache(args.cache)
    elif args.checkpoint or (args.params and args.meta):
        z, tc_k, is_sc, _ = load_by_encoding(args)
    else:
        p.error('give a latent cache, --checkpoint, or --params with --meta')
    n = min(args.n_samples, len(z))
    report(z[:n], tc_k[:n], is_sc[:n], args.top_k)


if __name__ == '__main__':
    main()
