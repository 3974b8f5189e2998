"""Shared set-up of the holdout search's parity tests
(tests/test_torch_port_holdout.py, tests/test_torch_port_holdout_search.py):
the tiny model (magpie_dim 78) on the corpus's first 2,000 rows, its
port and JAX searches from the same numpy parameters, and the micro
search's settings."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp

import superconductor_vae_tpu.generation.holdout_search as jhs
from superconductor_vae_tpu.generation import SuperconductorDiscoveryPipeline as JaxPipeline
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu_torch.data import load_dataset
from superconductor_vae_tpu_torch.generation import SuperconductorDiscoveryPipeline
from superconductor_vae_tpu_torch.generation import holdout_search as phs
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from torch_port_common import fix_rollout_heads, jax_config, param_trees, port_models

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
CFG = dataclasses.replace(tiny_test_config(), magpie_dim=78)
N_ROWS = 2000
STEPS = 24                        # descent steps in the parity tests
SNAP_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
# a micro search: every tier, every block, small shapes.  JAX decodes in
# chunks of 16 (one compiled shape a mode), the port each call in one batch
# (fewer rollouts); a greedy row's tokens do not depend on its batch, and
# the sampled decodes are the port's on both sides
MICRO = dict(budget_per_target=64, temperature_sweep=(0.0, 0.3), refine_rounds=1,
             guided_starts=4, inversion_starts=4, inversion_steps=STEPS,
             sample_slice=32, sample_draws=1)
JAX_CHUNK, PORT_CHUNK = 16, 512


def _jax_dataset(ds):
    """The JAX package's ``DatasetArrays`` holding the port's arrays (the
    two loaders are held bit-equal in tests/test_torch_port_dataset.py)."""
    from superconductor_vae_tpu.data.pipeline import DatasetArrays, NormStats
    names = [f.name for f in dataclasses.fields(DatasetArrays)]
    assert names == [f.name for f in dataclasses.fields(ds)]
    ns = NormStats(**dataclasses.asdict(ds.norm_stats))
    return DatasetArrays(**{k: ns if k == 'norm_stats' else getattr(ds, k) for k in names})


def make_sides():
    """(port search, JAX search, port cache, numpy trees) on the same
    weights and rows."""
    trees = fix_rollout_heads(param_trees(CFG, seed=5))
    enc, dec = port_models(CFG, trees)
    tok = default_tokenizer(max_len=CFG.max_len)
    ds = load_dataset(CSV, max_len=CFG.max_len, tokenizer=tok, limit=N_ROWS,
                      skew_transform='rank_gauss')
    jtok = jax_tokenizer(max_len=CFG.max_len)
    jds = _jax_dataset(ds)
    assert ds.magpie_dim == CFG.magpie_dim
    jcfg = jax_config(CFG)
    pipe = SuperconductorDiscoveryPipeline(enc, dec, tok, ds, type_masks=tok.type_masks)
    jpipe = JaxPipeline(JaxEncoder(jcfg), JaxDecoder(jcfg), trees[0], trees[1], jtok, jds,
                        type_masks=jnp.asarray(jtok.type_masks))
    search, jsearch = phs.HoldoutSearch(pipe), jhs.HoldoutSearch(jpipe)
    assert search.targets == jsearch.targets and len(search.targets) == 45
    return search, jsearch, pipe.analyzer.build_cache(ds), trees
