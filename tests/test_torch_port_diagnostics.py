"""The port's holdout campaign drivers and post-training diagnostics
(scripts/holdout_campaign.py, holdout_chunked.py, holdout_rerun_misses.py,
holdout_autoloop.sh, holdout_inversion_control.py, oracle_bisect.py,
generation_quality.py, order_robust_eval.py, analyze_physics_z.py)
against the JAX package's scripts, at tiny widths (magpie_dim 78) on the
corpus's first 400 rows, from the same numpy parameters.

The JAX scripts read an Orbax checkpoint; here their ``load_checkpoint``
is replaced by one that returns the same numpy trees (no JAX file
changes).  Greedy decodes only: the diagnostics' numbers (exact match,
taxonomy, oracle misses, respelling metrics) are equal, z cosines within
1e-5; the helpers (control sets, the error taxonomy, the physics-Z table)
are equal.  The campaign drivers run with their search subprocess
replaced by a stand-in that writes stream records; the card's smoke
(chip_smoke.py) runs the campaign's real subprocesses.
"""

import dataclasses
import functools
import gzip
import importlib.util
import io
import json
import os
import random
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

import superconductor_vae_tpu.checkpoint as jckpt
import superconductor_vae_tpu.data as jdata
import superconductor_vae_tpu.utils.cache as jcache
from superconductor_vae_tpu_torch.checkpoint import save_params_checkpoint
from superconductor_vae_tpu_torch.data import load_dataset
from superconductor_vae_tpu_torch.data.pipeline import (
    canonical_composition_key, parse_formula_composition, load_holdout_formulas)
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.scripts import (
    analyze_physics_z, generation_quality, holdout_campaign, holdout_chunked,
    holdout_inversion_control, holdout_rerun_misses, oracle_bisect, order_robust_eval)
from superconductor_vae_tpu_torch.scripts.holdout_search import K1_LINE
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import export_params_npz, fix_rollout_heads, param_trees, port_models

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
CFG = dataclasses.replace(tiny_test_config(), magpie_dim=78)
N_ROWS = 400
Z_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f'jax_{name}', ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """A port checkpoint, an npz export and the numpy trees of one tiny
    model with its rollout heads fixed, a meta, and a CSV of the corpus's
    first rows."""
    tmp = tmp_path_factory.mktemp('diagnostics')
    trees = fix_rollout_heads(param_trees(CFG, seed=3))
    enc, dec = port_models(CFG, trees)
    meta = {'epoch': 2, 'model_config': dataclasses.asdict(CFG),
            'data_norm': {'skew_transform': 'rank_gauss'}}
    ckpt = save_params_checkpoint(tmp / 'ckpt', {'enc_params': enc.state_dict(),
                                                 'dec_params': dec.state_dict()}, meta)
    export_params_npz({'enc_params': trees[0], 'dec_params': trees[1]}, tmp / 'params.npz')
    (tmp / 'meta.json').write_text(json.dumps(meta))
    with gzip.open(CSV, 'rt') as fh:
        (tmp / 'head.csv').write_text(''.join(next(fh) for _ in range(N_ROWS + 1)))
    return {'tmp': tmp, 'ckpt': ckpt, 'trees': trees, 'meta': meta,
            'csv': str(tmp / 'head.csv')}


@pytest.fixture
def jax_checkpoint(tiny, monkeypatch):
    """The JAX scripts' ``load_checkpoint`` returns the fixture's trees;
    their corpus loads and compiles write no cache."""
    restored = {'enc_params': tiny['trees'][0], 'dec_params': tiny['trees'][1]}
    monkeypatch.setattr(jckpt, 'load_checkpoint', lambda path: (restored, tiny['meta']))
    monkeypatch.setattr(jcache, 'enable_compilation_cache', lambda *a, **k: None)
    monkeypatch.setattr(jdata, 'load_dataset',
                        functools.partial(jdata.load_dataset, cache_dir=None))


def _run_jax(monkeypatch, name, argv):
    mod = _jax_script(name)
    monkeypatch.setattr(sys, 'argv', [f'{name}.py', *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


# -- the helpers -----------------------------------------------------------------------

def test_error_taxonomy_equals_jax():
    jax_gq = _jax_script('generation_quality')
    pairs = [('YBa2Cu3O7', 'YBa2Cu3O7'), ('YBa2Cu3O7', 'YBa2Cu3O6'),
             ('YBa2Cu3O7', 'YBa2Cu3O7F'), ('MgB2', 'MgB2Mg'), ('MgB2', 'Mg'),
             ('La2CuO4', 'La2Cu'), ('La2CuO4', ''), ('Nb3Sn', 'Nb3Sn2'),
             ('Nb3Sn', '(1/2)'), ('NbSe2', 'Se2Nb')]
    for t, g in pairs:
        assert generation_quality.classify_error(t, g) == jax_gq.classify_error(t, g), (t, g)


def test_inversion_control_sets_equal_jax(tiny):
    from superconductor_vae_tpu.data.pipeline import (
        canonical_composition_key as jkey, parse_formula_composition as jparse)
    from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
    jax_ic = _jax_script('holdout_inversion_control')
    for comp in ({'Cu': 1.0, 'O': 2.5, 'Y': 1 / 3}, {'Ba': 2, 'Tl': 0.95, 'Ca': 0.05},
                 {'Fe': 1.0}, {'Nb': 3, 'Sn': 1.0000001}):
        assert holdout_inversion_control.spell_alphabetical(comp) == \
            jax_ic.spell_alphabetical(comp)
    ds = load_dataset(tiny['csv'], max_len=CFG.max_len,
                      tokenizer=default_tokenizer(max_len=CFG.max_len))
    targets = load_holdout_formulas()
    corpus = {canonical_composition_key(f) for f in ds.formulas}
    held = {canonical_composition_key(f) for f in targets}
    for seed in (0, 3):
        got_rng, want_rng = random.Random(seed), random.Random(seed)
        got = holdout_inversion_control.build_scrambled(
            targets, corpus, held, parse_formula_composition, canonical_composition_key,
            got_rng, 24)
        want = jax_ic.build_scrambled(targets, corpus, held, jparse, jkey, want_rng, 24)
        assert got == want and len(got) > 5
        got = holdout_inversion_control.build_mutated_non_sc(
            ds, corpus, held, parse_formula_composition, canonical_composition_key, got_rng, 12,
            default_tokenizer(max_len=CFG.max_len))
        want = jax_ic.build_mutated_non_sc(ds, corpus, held, jparse, jkey, want_rng, 12,
                                           jax_tokenizer(max_len=CFG.max_len))
        assert got == want and len(got) == 12


def test_physics_z_table_equals_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    n = 96
    z = rng.standard_normal((n, 2048)).astype(np.float32)
    z[:, 5] = 0.003 * rng.standard_normal(n)                     # near-constant
    tc = np.abs(rng.standard_normal(n) * 30).astype(np.float32)
    z[:, 30] += 0.05 * np.log1p(tc)                             # Tc-correlated
    np.savez(tmp_path / 'latent_cache.npz', z=z, tc_kelvin=tc,
             is_sc=(rng.random(n) < 0.7).astype(np.int32), family=rng.integers(0, 14, n))
    argv = [str(tmp_path / 'latent_cache.npz'), '--n-samples', '80', '--top-k', '3']
    want = _run_jax(monkeypatch, 'analyze_physics_z', argv)
    analyze_physics_z.main(argv)
    got = capsys.readouterr().out
    assert got == want and 'bcs' in got and 'discovery space' in got


# -- the decoding CLIs against JAX's --------------------------------------------------

def _port_sources(tiny, which):
    if which == 'checkpoint':
        return ['--checkpoint', str(tiny['ckpt'])]
    return ['--params', str(tiny['tmp'] / 'params.npz'), '--meta', str(tiny['tmp'] / 'meta.json')]


def _last_json(text):
    """The JSON object a script printed last (before its K1 line)."""
    start = text.rindex('\n{\n') + 1 if '\n{\n' in text else text.index('{')
    return json.loads(text[start:text.index('\n}', start) + 2])


def test_oracle_bisect_equals_jax(tiny, jax_checkpoint, monkeypatch, capsys):
    args = ['--csv', tiny['csv'], '--n', '3', '--seed', '1', '--cpu']
    want = _last_json(_run_jax(monkeypatch, 'oracle_bisect', ['--checkpoint', 'x'] + args))
    got = oracle_bisect.main(_port_sources(tiny, 'params') + args)
    assert f'{K1_LINE} 0' in capsys.readouterr().out
    assert got['checkpoint'] == str(tiny['tmp'])
    assert {k: v for k, v in got.items() if k != 'checkpoint'} == \
        {k: v for k, v in want.items() if k != 'checkpoint'}
    assert got['n_encoded'] == 3


def test_generation_quality_equals_jax(tiny, jax_checkpoint, monkeypatch, tmp_path):
    args = ['--csv', tiny['csv'], '--limit', '48', '--cpu']
    _run_jax(monkeypatch, 'generation_quality', ['--checkpoint', 'x', '--out',
                                                 str(tmp_path / 'jax.json')] + args)
    generation_quality.main(_port_sources(tiny, 'checkpoint') + args
                            + ['--out', str(tmp_path / 'port.json')])
    got = json.loads((tmp_path / 'port.json').read_text())
    want = json.loads((tmp_path / 'jax.json').read_text())
    assert set(got) == set(want)
    for k in ('n_evaluated', 'ar_exact', 'tf_exact', 'error_taxonomy',
              'error_validity_rate', 'family_coarse_acc'):
        assert got[k] == want[k], k
    assert got['error_mean_similarity'] == pytest.approx(want['error_mean_similarity'], 1e-12)
    assert got['tc_mae_kelvin'] == pytest.approx(want['tc_mae_kelvin'], rel=1e-4)
    assert [(e['index'], e['generated']) for e in got['errors']] == \
        [(e['index'], e['generated']) for e in want['errors']]
    assert got['n_evaluated'] > 40 and sum(got['error_taxonomy'].values()) > 0


def test_order_robust_eval_equals_jax(tiny, jax_checkpoint, monkeypatch, tmp_path):
    args = ['--csv', tiny['csv'], '--limit', '24', '--k', '2', '--batch-size', '32', '--cpu']
    _run_jax(monkeypatch, 'order_robust_eval', ['--checkpoint', 'x', '--out',
                                                str(tmp_path / 'jax.json')] + args)
    got = order_robust_eval.main(_port_sources(tiny, 'checkpoint') + args)
    want = json.loads((tmp_path / 'jax.json').read_text())
    assert set(got) == set(want)
    for k in ('epoch', 'slice', 'n_source_rows', 'n_respellings', 'source_ar_exact',
              'source_composition_exact', 'respelled_ar_exact', 'composition_exact',
              'canonical_output_rate'):
        assert got[k] == want[k], k
    for k in ('z_cosine_mean', 'z_cosine_p5'):
        np.testing.assert_allclose(got[k], want[k], **Z_TOL)
    assert got['n_respellings'] > got['n_source_rows'] // 2


def test_inversion_control_cli(tiny, tmp_path, capsys):
    out = tmp_path / 'control.json'
    got = holdout_inversion_control.main(_port_sources(tiny, 'checkpoint') + [
        '--csv', tiny['csv'], '--cpu', '--n-scrambled', '1', '--n-non-sc', '1',
        '--budget', '16', '--inversion-starts', '2', '--inversion-steps', '2',
        '--refine-rounds', '0', '--decode-chunk', '32', '--out', str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    s = got['summary']
    assert s['n_controls'] == 2 and set(s['by_kind']) == {'scrambled', 'mutated_non_sc'}
    assert [s['by_kind'][k]['n'] for k in ('scrambled', 'mutated_non_sc')] == [1, 1]
    assert {r['kind'] for r in got['results']} == {'scrambled', 'mutated_non_sc'}
    for r in got['results']:
        assert set(r) == {'kind', 'target', 'exact', 'best_match', 'best_similarity',
                          'found_by', 'inversion_diag', 'consistent', 'consistency'}
        assert r['inversion_diag'] is not None
    assert f'{K1_LINE} 0' in capsys.readouterr().out


# -- the campaign drivers --------------------------------------------------------------

def _record(index, budget, exact=False, sim=0.5, seed=0):
    return {'index': index, 'budget': budget, 'seed': seed, 'exact': exact,
            'best_similarity': sim, 'target': f't{index}', 'exact_tier': None,
            'best_match': 'x', 'found_by': 'pool'}


class FakeSearch:
    """Stands in for the search subprocess: records each argv and streams
    a record for each target it was given."""

    def __init__(self, sims=None):
        self.calls = []
        self.sims = sims or {}

    def __call__(self, argv, timeout=None):
        self.calls.append(list(argv))
        a = dict(zip(argv, argv[1:]))
        lo, n = int(a['--target-offset']), int(a['--n-targets'])
        with open(a['--stream'], 'a') as fh:
            for i in range(lo, lo + n):
                fh.write(json.dumps(_record(i, int(a['--budget']),
                                            sim=self.sims.get(i, 0.5),
                                            seed=int(a['--seed']))) + '\n')
        return 0


def test_campaign_windows_resume_rotation_escalation(tiny, tmp_path, monkeypatch):
    assert holdout_campaign.window_order(45, 5, 0) == list(range(0, 45, 5))
    assert holdout_campaign.window_order(12, 5, 6) == [10, 0, 5]
    assert holdout_campaign.window_order(12, 5, 99) == [0, 5, 10]
    assert holdout_campaign.contiguous_runs([1, 2, 3, 5, 7, 8]) == [[1, 3], [5, 1], [7, 2]]
    stream = tmp_path / 'stream.jsonl'
    # a hand-written stream: target 1 finished at this budget, target 4 at a lower one
    stream.write_text(json.dumps(_record(1, 64)) + '\n' + json.dumps(_record(4, 32)) + '\n')
    fake = FakeSearch(sims={0: 0.9, 2: 0.7, 3: 0.95, 4: 0.2, 5: 0.8})
    monkeypatch.setattr(holdout_campaign, 'run_search', fake)
    common = _port_sources(tiny, 'params') + [
        '--cpu', '--pallas-decode', '--csv', tiny['csv'], '--budget', '64', '--n-targets', '6',
        '--window', '3', '--first-window', '3', '--refine-rounds', '0', '--no-oracle',
        '--stream', str(stream), '--out', str(tmp_path / 'summary.json')]
    summary = holdout_campaign.main(common + ['--escalate', '128'])
    runs = [(c[c.index('--target-offset') + 1], c[c.index('--n-targets') + 1],
             c[c.index('--budget') + 1], c[c.index('--seed') + 1]) for c in fake.calls]
    # the window at 3 first (rotation), then 0..2 without the streamed 1;
    # then the misses one by one, nearest first, at budget 128 and seed 1
    assert runs[:3] == [('3', '3', '64', '0'), ('0', '1', '64', '0'), ('2', '1', '64', '0')]
    assert runs[3:] == [(str(i), '1', '128', '1') for i in (3, 0, 5, 2, 1, 4)]
    for c in fake.calls:
        assert c[:4] == ['--params', str(tiny['tmp'] / 'params.npz'), '--meta',
                         str(tiny['tmp'] / 'meta.json')]
        assert {'--cpu', '--pallas-decode', '--no-oracle'} <= set(c)
    assert sorted(p.name for p in (tmp_path / 'summary_shards').glob('shard_*')) == \
        ['shard_00.json', 'shard_03.json']
    assert summary['targets_completed'] == 6 and summary['n_missing'] == 0
    assert summary == json.loads((tmp_path / 'summary.json').read_text())
    # a second run: every window cached, nothing launched
    fake.calls.clear()
    again = holdout_campaign.main(common)
    assert fake.calls == [] and again['targets_completed'] == 6


def test_chunked_and_rerun_misses(tiny, tmp_path, monkeypatch, capsys):
    jax_chunked = _jax_script('holdout_chunked')
    stream = tmp_path / 'stream.jsonl'
    recs = [_record(0, 64, sim=0.3), _record(2, 64, exact=True, sim=1.0),
            _record(3, 64, sim=0.9), _record(3, 128, sim=0.6)]
    stream.write_text('\n'.join(json.dumps(r) for r in recs) + '\nnot json\n\n')
    assert holdout_chunked.done_indices(stream) == jax_chunked.done_indices(stream) == {0, 2, 3}
    for done in ({0, 2, 3}, set(), set(range(6)), {1, 4}):
        for chunk in (1, 2, 5):
            assert holdout_chunked.next_chunk(done, 6, chunk) == \
                jax_chunked.next_chunk(done, 6, chunk)
    fake = FakeSearch()
    monkeypatch.setattr(holdout_campaign, 'run_search', fake)
    rc = holdout_chunked.main(_port_sources(tiny, 'checkpoint') + [
        '--stream', str(stream), '--n-total', '6', '--chunk', '2', '--', '--budget', '64',
        '--seed', '0', '--cpu'])
    assert rc == 0
    assert [(c[c.index('--target-offset') + 1], c[c.index('--n-targets') + 1])
            for c in fake.calls] == [('1', '1'), ('4', '2')]
    assert all(c[-5:] == ['--budget', '64', '--seed', '0', '--cpu'] for c in fake.calls)

    # rerun_misses: the plan is JAX's (dedup by summarize, nearest first)
    monkeypatch.syspath_prepend(str(ROOT / 'scripts'))
    jax_rerun = _jax_script('holdout_rerun_misses')
    stream.write_text('\n'.join(json.dumps(r) for r in recs) + '\n')
    want = jax_rerun.pick_misses(str(stream), None)
    capsys.readouterr()
    plan = holdout_rerun_misses.main(_port_sources(tiny, 'checkpoint') + [
        '--stream', str(stream), '--dry-run'])
    assert plan == want and [r['index'] for r in plan] == [3, 0]
    assert holdout_rerun_misses.pick_misses(str(stream), 1) == want[:1]
    assert '[3] sim=0.9000' in capsys.readouterr().out
    fake.calls.clear()
    holdout_rerun_misses.main(_port_sources(tiny, 'checkpoint') + [
        '--stream', str(stream), '--budget', '99', '--pallas-decode'])
    assert [c[c.index('--target-offset') + 1] for c in fake.calls] == ['3', '0']
    assert all('--pallas-decode' in c and c[c.index('--budget') + 1] == '99'
               for c in fake.calls)


def test_run_search_command_and_autoloop(tiny, tmp_path, monkeypatch):
    """The search subprocess's command line and environment (the package
    found through PYTHONPATH, the caller's paths kept); then the autoloop
    script, for real, over a stream without misses."""
    seen = {}

    def fake_run(cmd, timeout=None, env=None):
        seen.update(cmd=cmd, timeout=timeout, env=env)
        return subprocess.CompletedProcess(cmd, 3)

    def slow(cmd, timeout=None, env=None):
        raise subprocess.TimeoutExpired(cmd, timeout)

    with monkeypatch.context() as mp:
        mp.setattr(holdout_campaign.subprocess, 'run', fake_run)
        mp.setenv('PYTHONPATH', '/elsewhere')
        assert holdout_campaign.run_search(['--budget', '8'], timeout=5) == 3
        assert seen['cmd'] == [sys.executable, '-u', '-m',
                               'superconductor_vae_tpu_torch.scripts.holdout_search',
                               '--budget', '8']
        assert seen['timeout'] == 5
        assert seen['env']['PYTHONPATH'] == os.pathsep.join([str(ROOT), '/elsewhere'])
        mp.setattr(holdout_campaign.subprocess, 'run', slow)
        assert holdout_campaign.run_search([], timeout=1) == -1
    # the autoloop stops at once: an exact stream has no misses
    stream = tmp_path / 'stream.jsonl'
    stream.write_text(json.dumps(_record(0, 16, exact=True, sim=1.0)) + '\n')
    loop = subprocess.run(
        ['bash', str(ROOT / 'superconductor_vae_tpu_torch/scripts/holdout_autoloop.sh'),
         str(stream), str(tiny['ckpt']), '--', '--cpu'],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHON=sys.executable))
    assert loop.returncode == 0, loop.stderr
    assert '0 misses remain' in loop.stdout and 'autoloop complete' in loop.stdout
