"""Training CLI (port of scripts/train.py): drives ``train()`` of the
port, on the card unless ``--cpu``.

    python -m superconductor_vae_tpu_torch.scripts.train
    python -m superconductor_vae_tpu_torch.scripts.train --cpu --synthetic --tiny --epochs 1

The flags are the JAX CLI's; ``--set KEY=VALUE`` overrides any
``TrainConfig`` field with the same parsing.  With none, the run is at
``TrainConfig()``'s defaults, the set decoder and the A5 round-trip loss
included.  ``--csv`` defaults to the repo's corpus,
data/processed/jarvis_merged.csv.gz.  ``train_resilient.py`` relaunches
this CLI after a crash or a stall.

Data-parallel over N cards (or N CPU processes with ``--cpu``, over
gloo): launch it with ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK``; each rank joins the group (NCCL on the cards), takes
``cuda:<LOCAL_RANK>`` and its shard of every global batch of
``--batch-size`` rows, and rank 0 writes the log, the CSV and the
checkpoints (training/train_loop.py):

    torchrun --standalone --nproc_per_node=4 -m superconductor_vae_tpu_torch.scripts.train

With one process it runs as it always has.
"""

from __future__ import annotations

import argparse
import dataclasses

DEFAULT_CSV = 'data/processed/jarvis_merged.csv.gz'


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--csv', default=DEFAULT_CSV)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--limit', type=int, default=None,
                   help='cap dataset rows (smoke tests)')
    p.add_argument('--output', default='outputs')
    p.add_argument('--lr', type=float, default=None)
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU (default: the CUDA card)')
    p.add_argument('--synthetic', action='store_true',
                   help='use the synthetic dataset instead of a CSV')
    p.add_argument('--tiny', action='store_true',
                   help='tiny model config (CI/smoke)')
    p.add_argument('--rl-weight', type=float, default=None)
    p.add_argument('--bf16', action='store_true',
                   help='bfloat16 compute (float32 params and losses)')
    p.add_argument('--pallas-decode', action='store_true',
                   help='decode through K1, the decode-step attention kernel '
                        '(ModelConfig.pallas_decode): the eval and RL rollouts')
    p.add_argument('--resume', default=None,
                   help="'auto' or a checkpoint path")
    p.add_argument('--checkpoint-interval', type=int, default=None)
    p.add_argument('--set', action='append', default=[],
                   metavar='KEY=VALUE',
                   help='override any TrainConfig field, e.g. '
                        '--set rl_reactivation_min_exact=0.85')
    return p


def configs(p: argparse.ArgumentParser, args: argparse.Namespace):
    """(TrainConfig, ModelConfig or None) from the parsed flags: the
    flags and then each ``--set`` over ``TrainConfig()``; an unknown
    field is ``p``'s error."""
    from superconductor_vae_tpu_torch.models.config import ModelConfig, tiny_test_config
    from superconductor_vae_tpu_torch.training import TrainConfig

    tcfg = TrainConfig()
    if args.epochs is not None:
        tcfg.num_epochs = args.epochs
    if args.batch_size is not None:
        tcfg.batch_size = args.batch_size
    if args.lr is not None:
        tcfg.learning_rate = args.lr
    if args.rl_weight is not None:
        tcfg.rl_weight = args.rl_weight
    if args.bf16:
        tcfg.compute_dtype = 'bfloat16'
    if args.resume is not None:
        tcfg.resume = args.resume
    if args.checkpoint_interval is not None:
        tcfg.checkpoint_interval = args.checkpoint_interval
    for kv in args.set:
        key, _, raw = kv.partition('=')
        if not hasattr(tcfg, key):
            p.error(f'unknown TrainConfig field: {key}')
        cur = getattr(tcfg, key)
        val = (raw if isinstance(cur, str)
               else raw.lower() in ('1', 'true', 'yes') if isinstance(cur, bool)
               else type(cur)(raw) if cur is not None else float(raw))
        setattr(tcfg, key, val)

    mcfg = tiny_test_config() if args.tiny else None
    if args.tiny:
        tcfg.max_formula_len = mcfg.max_len
        tcfg.use_physics_z = False
    if args.pallas_decode:
        mcfg = dataclasses.replace(mcfg or ModelConfig(max_len=tcfg.max_formula_len),
                                   pallas_decode=True)
    return tcfg, mcfg


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)

    import os

    import torch

    from superconductor_vae_tpu_torch.parallel import init_distributed
    from superconductor_vae_tpu_torch.training import train

    tcfg, mcfg = configs(p, args)

    device = 'cpu' if args.cpu else 'cuda'
    distributed = int(os.environ.get('WORLD_SIZE', 1)) > 1
    if distributed:
        device = init_distributed(device)
    try:
        out = train(
            csv_path=None if args.synthetic else args.csv,
            model_config=mcfg,
            train_config=tcfg,
            output_dir=args.output,
            limit=args.limit,
            device=device,
        )
    finally:
        if distributed:
            torch.distributed.destroy_process_group()
    final = out['history'][-1]
    if int(os.environ.get('RANK', 0)) == 0:
        print(f"done: exact={final['exact_match']:.3f} "
              f"true_ar={final['true_ar_exact']:.3f} "
              f"throughput={final['samples_per_s']}/s")
    return out


if __name__ == '__main__':
    main()
