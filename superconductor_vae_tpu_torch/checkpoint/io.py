"""Full-state checkpoints in the port's own format (port of
checkpoint/io.py).

A checkpoint is a directory, ``<root>/epoch_NNNNN`` or ``<root>/<tag>``
('best', 'interrupt'), holding:
- ``state.pt``, a ``torch.save`` payload of CPU tensors: ``step``, the
  encoder's, decoder's, physics-Z projection's and set decoder's
  ``state_dict``s (``enc_params``, ``dec_params``, ``pz_params``,
  ``set_params``; the last two where the state has them), each
  optimizer's ``state_dict`` with its accumulation state (``enc_opt``,
  ``dec_opt``, ``pz_opt``, ``set_opt``), and what the caller adds (the loop's mastery arrays and
  Tc-bin tracker);
- ``meta.json`` with the JAX package's keys: ``epoch``, ``metrics``,
  ``model_config``, ``manifest``, ``controllers``, ``eval_gating`` and
  ``data_norm``.

Both files are written into a hidden temporary directory, which is then
renamed into place (an older save of the same name is moved aside first
and deleted after), so a checkpoint's directory holds one whole save or
none: a save cut off leaves at most a hidden directory, which
``latest_checkpoint`` never looks at.  The JAX package's Orbax directories
cannot be read here: the card's machine has no orbax or tensorstore (the
eval CLI reads their params from an npz export, ``from_jax.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from .manifest import build_manifest

PAYLOAD = 'state.pt'


def _ckpt_dir(root: Path, epoch: int) -> Path:
    return root / f'epoch_{epoch:05d}'


def _to_cpu(obj):
    """``obj`` with every tensor copied to the host (dicts and lists
    rebuilt, other leaves kept)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _replace_dir(new: Path, path: Path) -> None:
    """Renames the directory ``new`` to ``path``, moving an older ``path``
    aside first and deleting it after."""
    old = path.with_name(f'.{path.name}.old')
    shutil.rmtree(old, ignore_errors=True)
    if path.exists():
        os.replace(path, old)
    os.replace(new, path)
    shutil.rmtree(old, ignore_errors=True)


def save_checkpoint(root: str | Path, state, mcfg, tcfg,
                    epoch: int, metrics: Optional[Dict] = None,
                    tag: Optional[str] = None,
                    controllers: Optional[Dict] = None,
                    extra_arrays: Optional[Dict[str, Any]] = None) -> Path:
    """Saves the train state (params, every optimizer's state with its
    accumulators, the step count), ``controllers`` (plain data for
    ``meta.json``) and ``extra_arrays`` (tensors, into the payload) under
    ``root``; returns the checkpoint's directory."""
    root = Path(root).resolve()
    path = root / tag if tag else _ckpt_dir(root, epoch)
    tmp = path.with_name(f'.{path.name}.tmp')
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)

    payload: Dict[str, Any] = {'step': int(state.step),
                               'enc_params': state.encoder.state_dict(),
                               'dec_params': state.decoder.state_dict(),
                               'enc_opt': state.enc_opt.state_dict(),
                               'dec_opt': state.dec_opt.state_dict()}
    if state.pz_proj is not None:
        payload['pz_params'] = state.pz_proj.state_dict()
        payload['pz_opt'] = state.pz_opt.state_dict()
    if state.set_decoder is not None:
        payload['set_params'] = state.set_decoder.state_dict()
        payload['set_opt'] = state.set_opt.state_dict()
    if extra_arrays:
        payload.update(extra_arrays)
    torch.save(_to_cpu(payload), tmp / PAYLOAD)

    meta = {
        'epoch': epoch,
        'metrics': metrics or {},
        'model_config': dataclasses.asdict(mcfg),
        'manifest': build_manifest(mcfg, tcfg),
        'controllers': controllers or {},
        # the decode gates, so that offline eval decodes as training did
        'eval_gating': {
            'stop_boost': tcfg.stop_boost,
            'hard_stop_threshold': tcfg.hard_stop_threshold,
            'site_dup_threshold': tcfg.site_dup_threshold,
            'use_type_masking_ar': tcfg.use_type_masking_ar,
        },
        # the corpus transform the params were trained under
        'data_norm': {
            'skew_transform': tcfg.skew_transform,
            'order_augment': tcfg.order_augment,
        },
    }
    (tmp / 'meta.json').write_text(json.dumps(meta, indent=2, default=str))
    _replace_dir(tmp, path)
    return path


def ckpt_skew_transform(meta: Dict) -> str:
    """The Magpie skew transform a checkpoint's params were trained under.
    Checkpoints saved before the 'data_norm' meta key (run3, run4) trained
    on the legacy jittered rank-gauss corpus, and offline eval must reload
    the corpus with the same transform or every encoder input shifts."""
    return (meta.get('data_norm') or {}).get('skew_transform', 'rank_gauss')


def latest_checkpoint(root: str | Path) -> Optional[Path]:
    """'auto' resume resolution: the checkpoint with the HIGHEST epoch wins
    (epoch_* directories and the 'best' and 'interrupt' tags all compete),
    so a crash loop never rewinds to an older 'best'; on a tie the epoch_*
    directory wins.  A directory without both files is skipped."""
    root = Path(root)
    if not root.exists():
        return None
    candidates = []
    for p in list(root.glob('epoch_*')) + [root / 'best', root / 'interrupt']:
        meta = p / 'meta.json'
        if meta.exists() and (p / PAYLOAD).exists():
            try:
                ep = int(json.loads(meta.read_text()).get('epoch', -1))
            except (ValueError, json.JSONDecodeError):
                continue
            candidates.append((ep, 1 if p.name.startswith('epoch_') else 0, p))
    if not candidates:
        return None
    return max(candidates, key=lambda t: (t[0], t[1]))[2]


def load_checkpoint(path: str | Path) -> Tuple[Dict[str, Any], Dict]:
    """Returns (payload, meta): the payload's tensors on the CPU."""
    path = Path(path).resolve()
    restored = torch.load(path / PAYLOAD, map_location='cpu', weights_only=True)
    meta = json.loads((path / 'meta.json').read_text())
    return restored, meta
