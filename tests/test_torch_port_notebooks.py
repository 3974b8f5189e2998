"""The port's notebooks (notebooks/*_torch.ipynb), their code cells run in
order on the CPU at tiny sizes: the constants cell first, then the
overrides (a tiny Orbax snapshot from the JAX package's save_checkpoint,
the corpus's first 48 rows, a small slice, ``--cpu --tiny``), then the
rest.  The grade card's decoder SHA-256 equals the one the JAX notebook's
cell 2 takes of the same snapshot (``jax.tree.leaves``, raw bytes).
Neither notebook imports JAX, pandas or the JAX package."""

import ast
import dataclasses
import hashlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from superconductor_vae_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from superconductor_vae_tpu_torch.models import tiny_test_config

import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import head_csv, save_tiny_snapshot

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'


def code_cells(name):
    nb = json.loads((ROOT / 'notebooks' / name).read_text())
    return [''.join(c['source']) for c in nb['cells'] if c['cell_type'] == 'code']


def run(name, overrides, monkeypatch):
    """Runs the notebook's code cells in one namespace from the repo root,
    ``overrides`` applied after the first (the constants)."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr('sys.path', list(__import__('sys').path))
    cells = code_cells(name)
    ns = {'__name__': '__notebook__'}
    exec(compile(cells[0], f'{name}[0]', 'exec'), ns)
    ns.update(overrides)
    for i, src in enumerate(cells[1:], 1):
        exec(compile(src, f'{name}[{i}]', 'exec'), ns)
    return ns


@pytest.mark.parametrize('name', ['train_demo_torch.ipynb',
                                  'generative_evaluation_torch.ipynb'])
def test_notebook_imports_no_jax_or_pandas(name):
    for src in code_cells(name):
        for node in ast.walk(ast.parse(src)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split('.')[0] not in {
                    'jax', 'flax', 'optax', 'orbax', 'tensorstore', 'pandas',
                    'superconductor_vae_tpu'}, (name, mod)


def test_train_demo_runs(tmp_path, monkeypatch, capsys):
    csv = head_csv(CSV, tmp_path / 'head.csv', 48)
    out = tmp_path / 'nb_demo'
    ns = run('train_demo_torch.ipynb', {
        'CSV': str(csv), 'OUTPUT': str(out),
        'TRAIN_ARGS': ['--csv', str(csv), '--epochs', '1', '--limit', '32', '--batch-size', '16',
                       '--output', str(out), '--cpu', '--tiny', '--set', 'use_physics_z=false']},
        monkeypatch)
    assert len(ns['rows']['formula']) == 48
    assert [m['epoch'] for m in ns['metrics']] == ['0']
    assert '48 rows;' in capsys.readouterr().out


def test_generative_evaluation_runs(tmp_path, monkeypatch, capsys):
    cfg = dataclasses.replace(tiny_test_config(), magpie_dim=78, max_len=30)
    snap = save_tiny_snapshot(tmp_path / 'ckpt', cfg)
    ns = run('generative_evaluation_torch.ipynb', {
        'CHECKPOINT': str(snap), 'CSV': str(head_csv(CSV, tmp_path / 'head.csv', 48)),
        'SLICE': 16, 'N_CANDIDATES': 8, 'DEVICE': 'cpu'}, monkeypatch)
    # the JAX notebook's fingerprint of the same snapshot
    h = hashlib.sha256()
    for leaf in jax.tree.leaves(jax_load_checkpoint(snap)[0]['dec_params']):
        h.update(np.asarray(leaf).tobytes())
    assert ns['h'].hexdigest() == h.hexdigest()
    assert ns['out']['n_evaluated'] == 16 and sum(ns['fam_tot'].values()) == 16
    printed = capsys.readouterr().out
    assert f'decoder params sha256: {h.hexdigest()[:16]}' in printed
    assert 'validated candidates' in printed and 'grade' in printed
