"""The data slice and the dataset eval of the port against the JAX package:
``load_dataset`` with ``NormStats`` and ``DatasetArrays``, the holdout
keys, ``synthetic_dataset``, ``ckpt_skew_transform``,
``evaluate_autoregressive`` and the eval CLI.

The JAX side loads with ``cache_dir=None``, so its npz cache is neither
read nor written.  The arrays are compared bit for bit.  The eval's
token-level results (exact match, per-row and per-position arrays, error
records) are compared exactly; its float metrics at 1e-5 relative at tiny
width, and at run4 width within the float32 noise of a 12-layer model
(see ``test_cli_matches_jax_on_run4``).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import superconductor_vae_tpu.training.evaluate as jax_evaluate_mod
import superconductor_vae_tpu_torch.training.evaluate as port_evaluate_mod
from superconductor_vae_tpu.checkpoint import ckpt_skew_transform as jax_skew_transform
from superconductor_vae_tpu.checkpoint import load_checkpoint
from superconductor_vae_tpu.data import pipeline as jax_pipeline
from superconductor_vae_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.models.config import ModelConfig as JaxConfig
from superconductor_vae_tpu.models.family_classifier import (
    RuleBasedFamilyClassifier as JaxClassifier)
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu.training.train_step import build_luts as jax_luts
from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform
from superconductor_vae_tpu_torch.data import pipeline, synthetic_dataset
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.models.family_classifier import RuleBasedFamilyClassifier
from superconductor_vae_tpu_torch.scripts import evaluate as cli
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    build_luts, eval_train_config, evaluate_autoregressive)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import export_params_npz, jax_config, param_trees, port_models

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
RUN4 = ROOT / 'results/run4/ckpt_snapshot'
METAS = ['results/run3/ckpt_snapshot', 'results/run4/ckpt_snapshot',
         'results/run5/ckpt_snapshot', 'results/run5/ckpt_snapshot_r5']
ARRAYS = ('tokens', 'element_indices', 'element_fractions', 'element_mask', 'tc',
          'magpie', 'is_sc', 'label', 'hp', 'family', 'comp_targets')
N_CORPUS = 26917          # rows of the corpus kept by the default filters


def assert_same_stats(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        elif f.name == 'magpie_quantile_grids' and w is not None:
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            assert type(g) is type(w) and g == w, f.name


def assert_same_dataset(got, want):
    assert got.formulas == want.formulas
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert_same_stats(got.norm_stats, want.norm_stats)


_LOADS = {}


def corpus(skew_transform):
    """(port, JAX) datasets of the whole corpus, loaded once per process."""
    if skew_transform not in _LOADS:
        _LOADS[skew_transform] = (
            pipeline.load_dataset(CSV, skew_transform=skew_transform),
            jax_pipeline.load_dataset(CSV, cache_dir=None, skew_transform=skew_transform))
    return _LOADS[skew_transform]


@pytest.mark.parametrize('skew_transform', ['rank_gauss', 'quantile'])
def test_load_dataset_bit_equal_on_corpus(skew_transform):
    got, want = corpus(skew_transform)
    assert len(got) == N_CORPUS and got.magpie_dim == 78
    assert_same_dataset(got, want)
    if skew_transform == 'rank_gauss':      # run4's: the constants chip_smoke.py holds
        for ds in (got, want):              # the card's host to, whose rows carry 9 digits
            assert chip_smoke.check_corpus(ds) < 0.01


@pytest.mark.parametrize('kw', [dict(limit=500), dict(exclude_holdout=False),
                                dict(drop_unk=False)])
def test_load_dataset_options_bit_equal(kw):
    got = pipeline.load_dataset(CSV, **kw)
    assert_same_dataset(got, jax_pipeline.load_dataset(CSV, cache_dir=None, **kw))
    assert len(got) != N_CORPUS


SMALL_CSV = (
    'formula,Tc,source,magpie_a,magpie_b,requires_high_pressure,magpie_c\n'
    'NbTi,9.2,lab,1.5,,0,3\n'
    'MgB2,,lab,,2.0,1,4\n'
    'YBa2Cu3O7,92,paper,3.25,1.0,,5\n'
    'La(9/5)Sr(1/5)CuO4,38,paper,0.5,7.5,0,NA\n'
    '\n'
    'FeSe,8,lab,2.0,0.25,0,7\n'
    'Nb3Sn,18.3,lab,1.0,3.0,0\n'
    'H3S,203,paper,4.0,1.5,1,9\n'
    'Pb,7.2,lab,0.75,2.5,0,10\n')


def _both_load(path, **kw):
    """Port and JAX on one CSV: the datasets, or the exception types when
    both raise."""
    out = []
    for load in (pipeline.load_dataset, lambda p, **k: jax_pipeline.load_dataset(
            p, cache_dir=None, **k)):
        try:
            out.append(load(path, **kw))
        except Exception as e:          # noqa: BLE001 - compared below
            out.append(type(e))
    return out


@pytest.mark.parametrize('skew_transform', ['rank_gauss', 'quantile'])
def test_load_dataset_small_csv_like_pandas(tmp_path, skew_transform):
    """Empty and 'NA' numeric cells, a blank line, a short row, a string
    column, an empty ``requires_high_pressure`` cell, and no
    ``is_superconductor`` or ``category`` column: every row counts as a
    superconductor with label 0, the cells read as NaN."""
    path = tmp_path / 'rows.csv'
    path.write_text(SMALL_CSV)
    got, want = _both_load(path, skew_transform=skew_transform, skew_threshold=0.5)
    assert len(got) == 8 and got.magpie_dim == 3
    assert np.isnan(got.hp).sum() == 1 and (got.label == 0).all() and (got.is_sc == 1).all()
    assert got.formulas == want.formulas
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)      # NaN == NaN here
    assert_same_stats(got.norm_stats, want.norm_stats)


@pytest.mark.parametrize('edit', [
    ('source', 'category'),           # a category column: int(NaN) of the empty hp cell
    ('9.2', 'n/a'),                   # a missing Tc read as 0
    ('18.3', 'warm'),                 # a Tc that is no number
])
def test_load_dataset_small_csv_raises_where_jax_does(tmp_path, edit):
    path = tmp_path / 'rows.csv'
    path.write_text(SMALL_CSV.replace(*edit, 1))
    got, want = _both_load(path)
    if isinstance(want, type):
        assert got is want, (got, want)
    else:
        assert_same_dataset(got, want)


def test_norm_stats_methods():
    rng = np.random.default_rng(0)
    for transform in ('quantile', 'rank_gauss'):
        stats = corpus(transform)[0].norm_stats
        ref = jax_pipeline.NormStats(**dataclasses.asdict(stats))
        tc = rng.standard_normal(50).astype(np.float32)
        np.testing.assert_array_equal(stats.tc_to_kelvin(tc), ref.tc_to_kelvin(tc))
        kelvin = rng.uniform(0, 150, 50)
        np.testing.assert_array_equal(stats.kelvin_to_norm(kelvin), ref.kelvin_to_norm(kelvin))
        raw = rng.standard_normal((4, 78)) * 10
        for a, b in zip(stats.normalize_fresh_magpie(raw), ref.normalize_fresh_magpie(raw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert stats.to_json() == ref.to_json()
        json.dumps(stats.to_json())
        with pytest.raises(ValueError):
            stats.normalize_fresh_magpie(raw[:, :10])
    no_log = dataclasses.replace(stats, tc_log_transform=False)
    ref = jax_pipeline.NormStats(**dataclasses.asdict(no_log))
    np.testing.assert_array_equal(no_log.tc_to_kelvin(tc), ref.tc_to_kelvin(tc))
    np.testing.assert_array_equal(no_log.kelvin_to_norm(kelvin), ref.kelvin_to_norm(kelvin))


def test_subset_sample_indices_and_batch():
    got, want = corpus('quantile')
    for n, seed, strat in ((100, 0, False), (101, 3, True), (N_CORPUS + 5, 1, False)):
        idx = got.sample_indices(n, seed=seed, stratify_sc=strat)
        np.testing.assert_array_equal(idx, want.sample_indices(n, seed=seed, stratify_sc=strat))
        if n < N_CORPUS:
            assert_same_dataset(got.subset(idx), want.subset(idx))
    # a slice with three non-superconductors: the stratified sample tops up
    rows = np.concatenate([np.flatnonzero(got.is_sc == 1)[:50],
                           np.flatnonzero(got.is_sc != 1)[:3]])
    small, small_ref = got.subset(rows), want.subset(rows)
    idx = small.sample_indices(20, seed=2, stratify_sc=True)
    np.testing.assert_array_equal(idx, small_ref.sample_indices(20, seed=2, stratify_sc=True))
    assert len(idx) == 20 and (small.is_sc[idx] != 1).sum() == 3
    b, b_ref = got.batch(idx), want.batch(idx)
    assert b.keys() == b_ref.keys()
    for k in b:
        assert b[k].dtype == b_ref[k].dtype
        np.testing.assert_array_equal(b[k], b_ref[k])


def test_holdout_formulas_and_composition_keys():
    formulas = pipeline.load_holdout_formulas()
    assert formulas == jax_pipeline.load_holdout_formulas() and len(formulas) == 45
    others = ['', 'Xx2', 'H2O', '{18}O2', 'O2{18}', 'Ba0.2La1.8CuO4', 'La(9/5)Sr(1/5)CuO4',
              'Cu(0/0)O', 'Nb3Sn', 'Sn1Nb3']
    for f in formulas + others:
        assert (pipeline.canonical_composition_key(f)
                == jax_pipeline.canonical_composition_key(f)), f
    assert pipeline.load_holdout_formulas(ROOT / 'no_such_file.json') == []


def test_rule_based_family_classifier():
    sets = [{'Cu', 'O', 'Y', 'Ba'}, {'Cu', 'O', 'La', 'Sr'}, {'Cu', 'O', 'Bi', 'Sr'},
            {'Cu', 'O', 'Tl', 'Ba'}, {'Cu', 'O', 'Hg', 'Ba'}, {'Cu', 'O'}, {'Fe', 'As'},
            {'Fe', 'Se'}, {'Fe', 'Ni'}, {'Mg', 'B'}, {'Ce', 'Co', 'In'}, {'C', 'H', 'N'},
            {'C', 'K'}, {'Nb', 'Ti'}, {'Nb', 'Ti', 'Zr', 'Hf', 'V'}, set()]
    for s in sets:
        assert (RuleBasedFamilyClassifier().classify_from_elements(s)
                == JaxClassifier().classify_from_elements(s)), s


@pytest.mark.parametrize('seed', [0, 3])
def test_synthetic_dataset_bit_equal(seed):
    got = synthetic_dataset(n=256, magpie_dim=145, seed=seed)
    assert len(got) == 256
    assert_same_dataset(got, jax_synthetic(n=256, magpie_dim=145, seed=seed))


def test_ckpt_skew_transform_on_committed_metas():
    seen = []
    for d in METAS:
        meta = json.loads((ROOT / d / 'meta.json').read_text())
        assert ckpt_skew_transform(meta) == jax_skew_transform(meta)
        seen.append(ckpt_skew_transform(meta))
    assert seen[1] == 'rank_gauss' and 'quantile' in seen
    assert ckpt_skew_transform({}) == 'rank_gauss'


def test_unported_options_raise():
    """Options once refused run: the magpie bridge (A.16; held to JAX's in
    tests/test_torch_port_utils.py) widens the Magpie block to the
    bridge's layout; the speculative decode (A.13): a bare bigram table, at
    tiny width, gives streams that agree with the plain greedy scan up to
    each row's EOS."""
    bridged = pipeline.load_dataset(CSV, magpie_bridge=ROOT / 'data/magpie_bridge.npz',
                                    limit=64)
    w = np.load(ROOT / 'data/magpie_bridge.npz')['w']
    assert bridged.magpie.shape == (len(bridged), w.shape[1]) and len(bridged) > 0
    cfg = tiny_test_config()
    enc, dec = port_models(cfg, param_trees(cfg))
    ds = synthetic_dataset(n=4, max_len=cfg.max_len, magpie_dim=16)
    luts = build_luts(default_tokenizer(max_len=cfg.max_len), device='cpu')
    gates_off = dict(stop_boost=0.0, hard_stop_threshold=0.0, site_dup_threshold=0.0,
                     use_type_masking_ar=False)
    kw = dict(tcfg=eval_train_config(cfg.max_len, gates_off), luts=luts, batch_size=4,
              collect_errors=True, tokenizer=default_tokenizer(max_len=cfg.max_len))
    spec = evaluate_autoregressive(enc, dec, ds, speculative_tables=np.full(
        cfg.vocab_size, 7, np.int32), **kw)
    plain = evaluate_autoregressive(enc, dec, ds, **kw)
    assert spec['n_evaluated'] == plain['n_evaluated'] == len(spec['error_records']) == 4
    assert [e['generated'] for e in spec['error_records']] == [
        e['generated'] for e in plain['error_records']]


# -- the eval -----------------------------------------------------------------

class _Stop(Exception):
    pass


@pytest.mark.parametrize('eval_gating', [None, {'stop_boost': 4.0}])
def test_eval_gating_defaults_are_train_config_s(monkeypatch, eval_gating):
    """A meta without ``eval_gating``, or with only some of its keys: the
    port's eval decodes with the gates the JAX CLI builds, TrainConfig's
    defaults for the missing keys (stop boost 10, hard stop 0.8, type
    masking), and with the type masks."""
    cfg = tiny_test_config()
    seen = {}

    def stop(name):
        def record(*args, **kwargs):
            seen[name] = (args[6] if name == 'jax' else args[5], kwargs.get('type_masks'))
            raise _Stop
        return record
    monkeypatch.setattr(jax_evaluate_mod, 'generate_with_kv_cache', stop('jax'))
    monkeypatch.setattr(port_evaluate_mod, 'generate_with_kv_cache', stop('port'))
    ds = synthetic_dataset(n=4, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim)
    tcfg_jax = JaxTrainConfig(max_formula_len=cfg.max_len)
    for k, v in (eval_gating or {}).items():        # as scripts/evaluate.py does
        setattr(tcfg_jax, k, v)
    trees = param_trees(cfg)
    jcfg = jax_config(cfg)
    with pytest.raises(_Stop):
        jax_evaluate_mod.evaluate_autoregressive(
            JaxEncoder(jcfg), JaxDecoder(jcfg), trees[0], trees[1], ds, tcfg_jax,
            jax_luts(jax_tokenizer(max_len=cfg.max_len)), batch_size=4)
    enc, dec = port_models(cfg, trees)
    with pytest.raises(_Stop):
        evaluate_autoregressive(enc, dec, ds, eval_train_config(cfg.max_len, eval_gating),
                                build_luts(default_tokenizer(max_len=cfg.max_len), device='cpu'),
                                batch_size=4)
    (got, got_masks), (want, want_masks) = seen['port'], seen['jax']
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.stop_boost, got.hard_stop_threshold, got.use_type_masking) == (
        (eval_gating or {}).get('stop_boost', 10.0), 0.8, True)
    np.testing.assert_array_equal(got_masks.numpy(), np.asarray(want_masks))


def _tiny_eval_trees(cfg):
    """Random weights whose greedy rollouts end at varied steps (the stop
    head turned to rise along the rollout, the type head never predicting
    EOS), as in test_torch_port_generate.py."""
    trees = param_trees(cfg, seed=2)
    dec = trees[1]['params']
    dec['stop_d2']['kernel'] *= -1
    dec['stop_d2']['bias'][:] = 2.2
    dec['type_d3']['bias'][:] = [0.0, 0.0, 0.0, -3.0, -3.0]
    return trees


def _assert_eval_equal(got, want, rtol):
    for k in ('ar_exact', 'tf_exact', 'n_evaluated'):
        assert got[k] == want[k], k
    for k in ('per_sample_ar_exact', 'sample_indices', 'position_errors', 'position_mask'):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got['error_records']) == len(want['error_records'])
    for g, w in zip(got['error_records'], want['error_records']):
        assert {k: g[k] for k in ('index', 'formula', 'generated', 'family', 'tc_kelvin')} == {
            k: w[k] for k in ('index', 'formula', 'generated', 'family', 'tc_kelvin')}
        assert g['z_norm'] == pytest.approx(w['z_norm'], rel=rtol)
    for k in ('tc_mae_kelvin', 'z_norm_mean', 'family_coarse_acc'):
        assert got[k] == pytest.approx(want[k], rel=rtol), k
    for k in ('tc_r2_per_bin', 'sc_metrics'):
        assert got[k].keys() == want[k].keys(), k
        for key in want[k]:
            assert got[k][key] == pytest.approx(want[k][key], rel=rtol), (k, key)


@pytest.mark.parametrize('case', ['padded_last_batch_with_errors', 'indices_and_max_batches'])
def test_evaluate_autoregressive_matches_jax_tiny(case):
    """Tiny width on corpus rows: 40 stratified rows in batches of 16 (the
    last padded) with error records, or 37 sampled row indices of the
    corpus cut to 2 batches of 16."""
    cfg = dataclasses.replace(tiny_test_config(), magpie_dim=78, max_len=30)
    trees = _tiny_eval_trees(cfg)
    got_ds, want_ds = corpus('quantile')
    kw = dict(batch_size=16)
    if case == 'padded_last_batch_with_errors':
        idx = got_ds.sample_indices(40, seed=1, stratify_sc=True)
        got_ds, want_ds = got_ds.subset(idx), want_ds.subset(idx)
        kw.update(collect_errors=True)
    else:
        kw.update(sample_indices=got_ds.sample_indices(37, seed=5), max_batches=2)
    jcfg = jax_config(cfg)
    want = jax_evaluate_mod.evaluate_autoregressive(
        JaxEncoder(jcfg), JaxDecoder(jcfg), trees[0], trees[1], want_ds,
        JaxTrainConfig(max_formula_len=30), jax_luts(jax_tokenizer(max_len=30)),
        tokenizer=jax_tokenizer(max_len=30), **kw)
    enc, dec = port_models(cfg, trees)
    got = evaluate_autoregressive(
        enc, dec, got_ds, eval_train_config(30),
        build_luts(default_tokenizer(max_len=30), device='cpu'),
        tokenizer=default_tokenizer(max_len=30), **kw)
    _assert_eval_equal(got, want, 1e-5)
    assert got['n_evaluated'] == (40 if 'errors' in case else 32)
    if 'errors' in case:
        assert len(got['error_records']) == (~got['per_sample_ar_exact']).sum() > 0


def test_cli_matches_jax_on_run4(tmp_path):
    """The port's CLI (``--cpu``, ``--limit 64 --sample stratified``, in one
    batch of 64: the padding of a last batch is held in
    ``test_evaluate_autoregressive_matches_jax_tiny``) on
    run4's weights, through an npz exported from the snapshot, against the
    JAX package's evaluate_autoregressive on the same rows with the meta's
    gates: the same summary, exact match and error records.  Float metrics
    at 1e-4 relative: the Tc MAE is a mean of differences about 1e-3 of
    the Tc values, so the port's float32 noise in tc_pred (about 1e-6
    relative through 12 layers) is amplified there."""
    restored, meta = load_checkpoint(RUN4)
    npz = tmp_path / 'run4.npz'
    export_params_npz(restored, npz)
    cli.main(['--params', str(npz), '--meta', str(RUN4 / 'meta.json'), '--csv', str(CSV),
              '--limit', '64', '--sample', 'stratified', '--cpu', '--batch-size', '64',
              '--out', str(tmp_path / 'summary.json'),
              '--errors-out', str(tmp_path / 'errors.jsonl')])
    got = json.loads((tmp_path / 'summary.json').read_text())
    errors = [json.loads(x) for x in (tmp_path / 'errors.jsonl').read_text().splitlines()]

    ds = corpus('rank_gauss')[1]
    ds = ds.subset(ds.sample_indices(64, seed=0, stratify_sc=True))
    tcfg = JaxTrainConfig(max_formula_len=30)
    for k, v in meta['eval_gating'].items():
        setattr(tcfg, k, v)
    jcfg = JaxConfig(**meta['model_config'])
    tok = jax_tokenizer(max_len=30)
    want = jax_evaluate_mod.evaluate_autoregressive(
        JaxEncoder(jcfg), JaxDecoder(jcfg), restored['enc_params'], restored['dec_params'],
        ds, tcfg, jax_luts(tok), tokenizer=tok, batch_size=64, collect_errors=True)

    assert got['slice'] == {'sample': 'stratified', 'seed': 0, 'limit': 64}
    assert (got['epoch'], got['decode_path'], got['n_evaluated']) == (899, 'plain', 64)
    assert got['true_ar_exact'] == want['ar_exact'] and got['tf_exact'] == want['tf_exact']
    assert 0.9 < got['true_ar_exact'] < 1
    assert [(e['index'], e['generated']) for e in errors] == [
        (e['index'], e['generated']) for e in want['error_records']]
    for k in ('tc_mae_kelvin', 'z_norm_mean', 'family_coarse_acc'):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k in ('tc_r2_per_bin', 'sc_metrics'):
        assert got[k].keys() == want[k].keys()
        for key in want[k]:
            assert got[k][key] == pytest.approx(want[k][key], rel=1e-4), (k, key)
