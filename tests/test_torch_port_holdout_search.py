"""The port's generative holdout search (generation/holdout_search.py)
``search()`` and its CLIs (scripts/holdout_search.py,
scripts/holdout_summarize.py) against the JAX package, at tiny widths
(magpie_dim 78) on the corpus's first 2,000 rows, from the same numpy
parameters (``params_from_jax``); the parts are held in
tests/test_torch_port_holdout.py.

A micro search of two targets runs every tier.  Random draws cannot match
across frameworks, so the port's draws are recorded and fed to JAX
(``FedDraws``), and JAX's sampled-temperature decodes return the port's
formulas; everything deterministic (the pools' structure, the descents,
greedy decodes, scoring and the tier logic) is JAX's own.  No JAX file
changes.  The results are equal, the consistency and inversion
diagnostics within 1e-4 relative.
"""

import dataclasses
import functools
import gzip
import importlib.util
import json
import math

import jax.numpy as jnp
import pytest

import superconductor_vae_tpu.generation.holdout_search as jhs
import superconductor_vae_tpu.generation.latent as jlatent
from superconductor_vae_tpu.generation import SuperconductorDiscoveryPipeline as JaxPipeline
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu_torch.checkpoint import save_params_checkpoint
from superconductor_vae_tpu_torch.data import load_dataset
from superconductor_vae_tpu_torch.generation import holdout_search as phs
from superconductor_vae_tpu_torch.scripts import holdout_search as search_cli
from superconductor_vae_tpu_torch.scripts import holdout_summarize as summarize_cli
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import FedDraws, export_params_npz, jax_config, port_models
from torch_port_holdout_common import (
    CFG, CSV, JAX_CHUNK, MICRO, PORT_CHUNK, ROOT, STEPS, _jax_dataset, make_sides)


@pytest.fixture(scope='module')
def sides():
    """(port search, JAX search, port cache, trees) on the same weights and rows."""
    return make_sides()


# -- search() -------------------------------------------------------------------------

def _reduced_descents(search, monkeypatch):
    """The search's guided descents at STEPS steps (240 by default)."""
    monkeypatch.setattr(search, 'head_guided_latents',
                        functools.partial(search.head_guided_latents, steps=STEPS))


@pytest.fixture(scope='module')
def micro_searches(sides):
    """The micro search on the first two targets: the port's, and JAX's
    fed the port's draws and sampled decodes."""
    search, jsearch, _, _ = sides
    fed = FedDraws()
    sampled = []
    decode, jdecode = search.pipe.decode_latents, jsearch.pipe.decode_latents

    def recorded(z, temperature=0.0, **kw):
        fs = decode(z, temperature=temperature, **kw)
        if temperature >= 0.01:
            sampled.append(fs)
        return fs

    def fed_decode(z, temperature=0.0, **kw):
        if temperature >= 0.01:
            fs = sampled.pop(0)
            assert len(fs) == len(z)
            return fs
        return jdecode(z, temperature=temperature, **kw)

    with pytest.MonkeyPatch.context() as mp:
        _reduced_descents(search, mp)
        _reduced_descents(jsearch, mp)
        mp.setattr(search.pipe, 'decode_latents', recorded)
        with fed.recording():
            got = search.search(targets=search.targets[:2], log_fn=lambda *a: None,
                                decode_chunk=PORT_CHUNK, **MICRO)
        fed.feeding(mp, jhs, jlatent)
        mp.setattr(jsearch.pipe, 'decode_latents', fed_decode)
        want = jsearch.search(targets=jsearch.targets[:2], log_fn=lambda *a: None,
                              decode_chunk=JAX_CHUNK, **MICRO)
    assert fed.exhausted() and not sampled
    return got, want


def _same_result(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in ('consistency', 'inversion_diag') and x is not None:
            assert set(x) == set(y)
            for k in x:
                assert math.isclose(x[k], y[k], rel_tol=1e-4, abs_tol=1e-5), (f.name, k)
        elif f.name != 'wall_s':
            assert x == y, (f.name, x, y)


def test_micro_search_equals_jax(micro_searches):
    got, want = micro_searches
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _same_result(a, b)
        assert a.n_candidates > 20 and a.oracle_masks == 'generic'
    # every tier ran (nothing found), and the inversion's diagnostics
    assert all(set(r.tier_sim) == {'navigation', 'guided', 'inversion'} for r in got)
    assert all(r.inversion_diag is not None for r in got)
    assert phs.HoldoutSearch.summarize(got) == jhs.HoldoutSearch.summarize(want)


def test_target_offset_streams(sides, micro_searches, monkeypatch):
    """A target searched alone, at its absolute index, gives the result it
    has in a search over targets 0-1."""
    search = sides[0]
    _reduced_descents(search, monkeypatch)
    alone = search.search(targets=search.targets[1:2], target_offset=1,
                          log_fn=lambda *a: None, decode_chunk=PORT_CHUNK, **MICRO)
    assert alone == [micro_searches[0][1]]


# -- the CLIs -------------------------------------------------------------------------

def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f'jax_{name}', ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def tiny_checkpoint(tmp_path_factory, sides):
    """A port checkpoint and an npz export of the fixture's weights, and a
    corpus CSV of the first 600 rows."""
    tmp = tmp_path_factory.mktemp('holdout_cli')
    trees = sides[3]
    enc, dec = port_models(CFG, trees)
    meta = {'model_config': dataclasses.asdict(CFG), 'data_norm': {'skew_transform': 'rank_gauss'}}
    ckpt = save_params_checkpoint(tmp / 'ckpt', {'enc_params': enc.state_dict(),
                                                 'dec_params': dec.state_dict()}, meta)
    export_params_npz({'enc_params': trees[0], 'dec_params': trees[1]}, tmp / 'params.npz')
    (tmp / 'meta.json').write_text(json.dumps(meta))
    with gzip.open(CSV, 'rt') as fh:
        (tmp / 'head.csv').write_text(''.join(next(fh) for _ in range(601)))
    return tmp, ckpt


def test_cli_oracle_only(sides, tiny_checkpoint):
    tmp, ckpt = tiny_checkpoint
    trees = sides[3]
    common = ['--cpu', '--csv', str(tmp / 'head.csv'), '--oracle-only', '--n-targets', '6']
    out = search_cli.main(['--checkpoint', str(ckpt), '--out', str(tmp / 'oracle.json')]
                          + common)
    again = search_cli.main(['--params', str(tmp / 'params.npz'), '--meta',
                             str(tmp / 'meta.json'), '--out', str(tmp / 'oracle2.json')] + common)
    written = json.loads((tmp / 'oracle.json').read_text())
    assert written['summary'] == out['summary'] and out['summary']['n_targets'] == 6
    assert written['results'] == again['results'] == out['results']
    # JAX's oracle on the same weights and corpus
    jtok = jax_tokenizer(max_len=CFG.max_len)
    jds = _jax_dataset(load_dataset(tmp / 'head.csv', max_len=CFG.max_len,
                                    tokenizer=default_tokenizer(max_len=CFG.max_len),
                                    skew_transform='rank_gauss'))
    jcfg = jax_config(CFG)
    jsearch = jhs.HoldoutSearch(JaxPipeline(JaxEncoder(jcfg), JaxDecoder(jcfg), *trees,
                                            jtok, jds, type_masks=jnp.asarray(jtok.type_masks)))
    for rec in out['results']:
        t = rec['target']
        assert rec['oracle_formula'] == jsearch.oracle_reconstruct(
            t, type_masks=jsearch._element_type_masks(t))[0]


def test_cli_micro_search_and_summarize(tiny_checkpoint):
    tmp, ckpt = tiny_checkpoint
    stream = tmp / 'stream.jsonl'
    out = search_cli.main([
        '--checkpoint', str(ckpt), '--cpu', '--csv', str(tmp / 'head.csv'), '--budget', '32',
        '--n-targets', '1', '--target-offset', '3', '--refine-rounds', '0', '--no-guided',
        '--inversion-steps', '8', '--inversion-starts', '2',
        '--sample-draws', '1', '--strategy-order', 'inversion_first',
        '--no-snap-stoich', '--stream', str(stream), '--out', str(tmp / 'search.json')])
    written = json.loads((tmp / 'search.json').read_text())
    assert written['summary'] == out['summary'] and out['summary']['n_targets'] == 1
    records = [json.loads(x) for x in stream.read_text().splitlines()]
    assert len(records) == 1 and records[0]['index'] == 3 and records[0]['budget'] == 32
    assert records[0]['strategy_order'] == 'inversion_first'
    assert records[0]['target'] == written['results'][0]['target']
    summary = summarize_cli.main(['--stream', str(stream), '--out', str(tmp / 'summary.json'),
                                  '--note', 'micro'])
    assert summary == json.loads((tmp / 'summary.json').read_text())
    want = _jax_script('holdout_summarize').summarize(records)
    assert {k: v for k, v in summary.items() if k != 'note'} == want
    assert summary['targets_completed'] == 1
