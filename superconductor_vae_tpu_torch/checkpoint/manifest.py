"""Checkpoint manifest: environment and config fingerprints (port of
checkpoint/manifest.py).

Records the git SHA, the library versions, hashes of the port's own
``ModelConfig`` and ``TrainConfig`` and an architecture fingerprint; on
resume ``check_manifest_drift`` compares the stored manifest with the
current run and names the fields that differ.  The hashes are of the
port's configs, so they need not equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

_ROOT = Path(__file__).resolve().parents[2]


def _git_sha() -> str:
    """HEAD of the checkout the package sits in ('unknown' outside git)."""
    try:
        return subprocess.run(
            ['git', 'rev-parse', 'HEAD'], capture_output=True, text=True,
            timeout=5, cwd=_ROOT).stdout.strip() or 'unknown'
    except (OSError, subprocess.SubprocessError):
        return 'unknown'


def _hash_config(obj) -> str:
    try:
        blob = json.dumps(dataclasses.asdict(obj), sort_keys=True, default=str)
    except TypeError:
        blob = repr(obj)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def architecture_fingerprint(mcfg) -> str:
    key = (f'{mcfg.latent_dim}|{mcfg.d_model}|{mcfg.nhead}|{mcfg.num_layers}|'
           f'{mcfg.dim_feedforward}|{mcfg.vocab_size}|{mcfg.max_len}|'
           f'{mcfg.n_total_memory_tokens}|{mcfg.fusion_dim}')
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def build_manifest(mcfg, tcfg) -> Dict[str, str]:
    return {
        'git_sha': _git_sha(),
        'platform': platform.platform(),
        'torch_version': torch.__version__,
        'cuda': str(torch.version.cuda),
        'model_config_hash': _hash_config(mcfg),
        'train_config_hash': _hash_config(tcfg),
        'architecture_fingerprint': architecture_fingerprint(mcfg),
    }


def check_manifest_drift(saved: Dict[str, str], mcfg, tcfg) -> List[str]:
    """Returns a list of drifted fields (empty = clean resume)."""
    current = build_manifest(mcfg, tcfg)
    drift = []
    for key in ('architecture_fingerprint', 'model_config_hash',
                'train_config_hash'):
        if saved.get(key) != current[key]:
            drift.append(f'{key}: {saved.get(key)} -> {current[key]}')
    return drift
