"""The latent-space topology CLI over latent caches (port of
scripts/compute_topology.py): compact, ``--full`` (per-cluster quality
and per-sample tiers) and ``--longitudinal`` (every cache a glob matches,
a JSON line each) reports, through analysis/topology.py's
``TopologyAnalyzer``.  A cache is the npz that ``train()`` writes
(``<output>/latent_cache.npz``: z, is_sc, tc_kelvin; bf16 arrays read
through utils/npz.py ``as_f32``).

    python -m superconductor_vae_tpu_torch.scripts.compute_topology outputs/latent_cache.npz
    python -m superconductor_vae_tpu_torch.scripts.compute_topology outputs/latent_cache.npz --full
    python -m superconductor_vae_tpu_torch.scripts.compute_topology --longitudinal 'outputs/*/latent_cache.npz'
"""

import argparse
import glob
import json

import numpy as np

from superconductor_vae_tpu_torch.analysis.topology import TopologyAnalyzer
from superconductor_vae_tpu_torch.utils.npz import as_f32

COMPACT_KEYS = ('n_samples', 'intrinsic_dim_mle', 'intrinsic_dim_mle_sc', 'correlation_dim',
                'pca_effective_rank', 'z_norm_mean', 'knn_radius_mean', 'sc_boundary_ratio',
                'boundary_fraction', 'n_clusters_hdbscan', 'cluster_noise_fraction')


def analyze_cache(path, k: int, n_samples: int, full: bool) -> dict:
    """``TopologyAnalyzer(k).analyze`` of a cache's first ``n_samples``
    rows, with the cache's path."""
    blob = np.load(path)
    z = as_f32(blob['z'])[:n_samples]
    is_sc = blob['is_sc'][:n_samples].astype(np.int32)
    tc_k = as_f32(blob['tc_kelvin'])[:n_samples]
    out = TopologyAnalyzer(k=k).analyze(z, is_sc=is_sc, tc_kelvin=tc_k, full=full)
    out['cache'] = str(path)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('cache', nargs='?', default='outputs/latent_cache.npz')
    p.add_argument('--k', type=int, default=20)
    p.add_argument('--n-samples', type=int, default=4096)
    p.add_argument('--full', action='store_true',
                   help='include per-cluster quality + per-sample tiers')
    p.add_argument('--longitudinal', default=None, metavar='GLOB',
                   help='analyze every cache matching a glob, one JSONL line each')
    p.add_argument('--out', default=None, help='append JSONL here')
    args = p.parse_args(argv)

    paths = sorted(glob.glob(args.longitudinal)) if args.longitudinal else [args.cache]
    if not paths:
        print('no caches matched')
        return
    for path in paths:
        out = analyze_cache(path, args.k, args.n_samples, args.full)
        line = json.dumps({k: v for k, v in out.items() if not isinstance(v, np.ndarray)},
                          default=float)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
        if len(paths) == 1:
            for key in COMPACT_KEYS:          # a human-readable compact report
                if key in out:
                    v = out[key]
                    sv = f'{v:.4f}' if isinstance(v, float) else str(v)
                    print(f'  {key:<26}{sv}')
        else:
            print(line)


if __name__ == '__main__':
    main()
