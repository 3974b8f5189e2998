"""A params-only snapshot of a checkpoint, in the port's format (port of
scripts/snapshot_params.py).  The source is a checkpoint of either package
(``load_train_checkpoint``: an Orbax checkpoint of the JAX package is
converted on the way in, its bf16 or float32 leaves as float32 tensors).

It keeps the inference payload (every model's parameters and the step
count; no optimizer moments or accumulators), casts float32 tensors to
bfloat16 (the training compute dtype, so eval and the holdout search
decode as the bf16-rounded source does) unless ``--keep-fp32``, and
writes it with the source's meta.json (plus a ``snapshot`` note) as a
checkpoint that ``load_checkpoint``, the eval and holdout CLIs and
``train(resume=...)`` read: a params-only checkpoint resumes with fresh
optimizers.  About half the bytes of the parameters in float32, and no
moments (a third of a full checkpoint's).

    python -m superconductor_vae_tpu_torch.scripts.snapshot_params \\
        --checkpoint outputs/checkpoints/best --out results/snapshot
"""

import argparse
import json
from pathlib import Path

import torch

from superconductor_vae_tpu_torch.checkpoint import load_train_checkpoint, save_params_checkpoint


def _cast(obj, keep_fp32: bool):
    """Every float32 tensor in ``obj`` (nested dicts) cast to bfloat16."""
    if isinstance(obj, dict):
        return {k: _cast(v, keep_fp32) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor) and obj.dtype == torch.float32 and not keep_fp32:
        return obj.to(torch.bfloat16)
    return obj


def _nbytes(obj) -> int:
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    return obj.numel() * obj.element_size() if isinstance(obj, torch.Tensor) else 0


def snapshot(src: Path, out: Path, keep_fp32: bool = False) -> int:
    """Writes the snapshot of the checkpoint ``src`` to ``out``; returns its
    payload's bytes."""
    restored, meta, _ = load_train_checkpoint(src)
    payload = _cast({k: v for k, v in restored.items() if not k.endswith('_opt')}, keep_fp32)
    meta['snapshot'] = {'source': str(src),
                        'params_dtype': 'float32' if keep_fp32 else 'bfloat16'}
    save_params_checkpoint(out, payload, meta)
    return _nbytes(payload)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--keep-fp32', action='store_true',
                   help='skip the bf16 downcast (2x the size)')
    args = p.parse_args(argv)
    src, out = Path(args.checkpoint).resolve(), Path(args.out).resolve()
    n = snapshot(src, out, args.keep_fp32)
    print(f'snapshot: {src} -> {out} ({n / 1e6:.0f} MB)')
    return json.loads((out / 'meta.json').read_text())['snapshot']


if __name__ == '__main__':
    main()
