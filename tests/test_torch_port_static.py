"""Static properties of the port: it imports no JAX and nothing of the JAX
package, its config mirrors the JAX config, and its CUDA entry points
refuse to run without a card."""

import ast
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from superconductor_vae_tpu.models.config import ModelConfig as JaxConfig
from superconductor_vae_tpu.models.config import tiny_test_config as jax_tiny
from superconductor_vae_tpu_torch.models import (
    FormulaDecoder, MaterialsEncoder, ModelConfig, config_from_meta, tiny_test_config)
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import build_luts

import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / 'superconductor_vae_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'superconductor_vae_tpu'}


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    assert len(PORT_FILES) > 10
    for path in PORT_FILES:
        for mod in _imported_modules(path):
            assert mod.split('.')[0] not in FORBIDDEN, f'{path}: imports {mod}'


def test_config_mirrors_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxConfig)])
    assert dataclasses.asdict(tiny_test_config()) == dataclasses.asdict(jax_tiny())
    meta = json.loads((ROOT / 'results/run4/ckpt_snapshot/meta.json').read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    want = {k: tuple(v) if isinstance(v, list) else v          # JSON lists
            for k, v in dataclasses.asdict(JaxConfig(**meta['model_config'])).items()}
    assert dataclasses.asdict(cfg) == dict(want, pallas_decode=True)
    assert (cfg.magpie_dim, cfg.head_dim, cfg.n_total_memory_tokens) == (78, 72, 24)
    with pytest.raises(ValueError):
        config_from_meta({'no_such_field': 1})


@pytest.mark.parametrize('entry', [
    lambda: MaterialsEncoder(tiny_test_config()),
    lambda: FormulaDecoder(tiny_test_config()),
    lambda: build_luts(default_tokenizer(max_len=16)),
])
def test_cuda_default_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry()
