"""Phase 2 of the port (training/self_supervised.py, its train() hook and
scripts/phase2_standalone.py) against the JAX package's
``SelfSupervisedEpoch``, at tiny widths with dropout 0.1 and the modules in
train mode on entry (JAX's Phase 2 is deterministic, so a forward that
dropped out would show).

Sampling cannot match across frameworks (a torch generator against JAX
keys), so the sub-epoch tests record the port's latents and rollout tokens
and feed them to JAX: its ``SelfSupervisedEpoch.sample_latents`` (on the
instance) and the ``generate_with_kv_cache`` that
``superconductor_vae_tpu.training.self_supervised`` calls are monkeypatched
in the test; no JAX file changes.  The greedy half is also held against
JAX's own greedy rollout on the same latents.

Tolerance: the metrics that count (accepted, novel, unique rate, collapse
state, sigma, weight) are equal; the losses agree within 1e-5 relative
(float32 on both sides, other summation orders); the AdamW moments and the
parameter changes are held as tests/test_torch_port_train_step.py holds a
train step's (``check_moments_and_updates``).  ``explore_temp`` is drawn
from each side's own stream and is not compared, except where the collapse
intervention fixes it.
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.data import synthetic_dataset as jax_synthetic
from superconductor_vae_tpu.generation import GenerationConfig as JaxGenConfig
from superconductor_vae_tpu.generation import generate_with_kv_cache as jax_generate
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import self_supervised as jss
from superconductor_vae_tpu.training.train_step import build_luts as jax_luts
from superconductor_vae_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from superconductor_vae_tpu_torch.data import load_dataset, synthetic_dataset
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.scripts import phase2_standalone
from superconductor_vae_tpu_torch.scripts import train as train_cli
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    Phase2Config, SelfSupervisedEpoch, TrainConfig, build_luts, create_train_state, train)
from superconductor_vae_tpu_torch.training.self_supervised import ADAMW_WEIGHT_DECAY
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_train_step import check_moments_and_updates
from torch_port_common import jax_config, param_trees, port_models

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
CFG = tiny_test_config()                       # dropout 0.1
P2 = dict(n_samples=16, coverage_k=4)
BASE_LR = 3e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
# short formulas the real validators accept and reject, for a fixed rollout
FORMULAS = ['MgB2', 'Nb3Sn', 'FeSe', 'YBa2Cu3O7', 'NaCl', 'FeCu', 'He', 'TlF',
            'CsF', 'LaH10', 'V3Si', 'PbAl', 'UPt3', 'CeCu2Si2', 'Cu60O3', 'FeCuAgW']


class _Accept:
    """The permissive validators of tests/test_phase2.py."""

    def validate(self, f):
        return SimpleNamespace(is_valid=True, score=1.0, is_plausible=True)


def _z_cache(seed=0):
    return np.random.default_rng(seed).normal(size=(48, CFG.latent_dim)).astype(np.float32)


def _port_side(trees, permissive=True):
    assert CFG.dropout == 0.1
    enc, dec = port_models(CFG, trees)
    enc.train()
    dec.train()
    tok = default_tokenizer(max_len=CFG.max_len)
    ds = synthetic_dataset(n=48, max_len=CFG.max_len, magpie_dim=CFG.magpie_dim)
    p2 = SelfSupervisedEpoch(enc, dec, tok, ds, build_luts(tok, device='cpu'),
                             cfg=Phase2Config(**P2), base_lr=BASE_LR)
    if permissive:
        p2.validator = p2.physics = _Accept()
    rec = {'z': [], 'tokens': []}
    sample, rollouts = p2.sample_latents, p2.rollouts
    p2.sample_latents = lambda *a: rec['z'].append(sample(*a)) or rec['z'][-1]
    p2.rollouts = lambda *a: rec['tokens'].append(rollouts(*a)) or rec['tokens'][-1]
    return p2, rec


def _jax_side(permissive=True):
    jcfg = jax_config(CFG)
    tok = jax_tokenizer(max_len=CFG.max_len)
    ds = jax_synthetic(n=48, max_len=CFG.max_len, magpie_dim=CFG.magpie_dim)
    jp2 = jss.SelfSupervisedEpoch(JaxEncoder(jcfg), JaxDecoder(jcfg), tok, ds, jax_luts(tok),
                                  cfg=jss.Phase2Config(**P2), base_lr=BASE_LR)
    if permissive:
        jp2.validator = jp2.physics = _Accept()
    return jp2


def _feed_jax(jp2, rec, monkeypatch):
    """JAX's sampling and rollouts replaced by the port's recorded ones."""
    zs = iter([z.numpy() for z in rec['z']])
    n_greedy = int(P2['n_samples'] * 0.5)
    halves = iter([h.numpy().astype(np.int32) for t in rec['tokens']
                   for h in (t[:n_greedy], t[n_greedy:])])

    def sample_latents(z_cache, rng):
        if jp2.coverage.centers is None:
            jp2.coverage.fit(z_cache, method='hdbscan')
        return jnp.asarray(next(zs))

    def generate(decoder, params, z, stoich, heads_vec, rng, gcfg, **kw):
        tokens = next(halves)
        assert tokens.shape[0] == z.shape[0] and gcfg.max_len == CFG.max_len
        return {'tokens': jnp.asarray(tokens)}

    jp2.sample_latents = sample_latents
    monkeypatch.setattr(jss, 'generate_with_kv_cache', generate)


def _params(p2):
    return [{k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
            for m in (p2.encoder, p2.decoder)]


def _moments(p2):
    return [{n: (opt.state[p]['exp_avg'].numpy().copy(), opt.state[p]['exp_avg_sq'].numpy().copy())
             for n, p in m.named_parameters()}
            for m, opt in ((p2.encoder, p2._enc_opt), (p2.decoder, p2._dec_opt))]


def _jax_state(enc_params, dec_params, jp2=None):
    """What ``check_moments_and_updates`` reads of a JAX state; the
    ``chain(clip, adamw)`` state wrapped as it finds the train step's."""
    def opt(s):
        return (None, SimpleNamespace(inner_state=s[1])) if s is not None else None
    return SimpleNamespace(enc_params=enc_params, dec_params=dec_params,
                           enc_opt=opt(jp2 and jp2._enc_opt), dec_opt=opt(jp2 and jp2._dec_opt))


def _check_metrics(got, want, skip=('explore_temp',)):
    assert set(got) == set(want)
    for k, w in want.items():
        if k in skip:
            continue
        if 'loss' in k or 'mse' in k:
            np.testing.assert_allclose(got[k], w, **LOSS_TOL, err_msg=k)
        else:
            assert got[k] == w, k


def _coverage_equal(a, b):
    for k in ('centers', 'visits', 'quality', 'quality_seen'):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def _fixed_tokens(formulas):
    """The stream of ``formulas`` without BOS, [n, max_len - 1]."""
    return torch.as_tensor(default_tokenizer(max_len=CFG.max_len).encode_batch(formulas)[:, 1:],
                           dtype=torch.long)


# -- (b) two sub-epochs: metrics, moments and parameter changes ----------------------

@pytest.fixture(scope='module')
def two_sub_epochs():
    trees = param_trees(CFG)
    p2, rec = _port_side(trees)
    before = [_params(p2)]
    port_metrics, moments = [], []
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        out = p2.run(_z_cache(), gen, phase2_weight=0.1, current_exact=0.9)
        port_metrics.append(out['metrics'])
        before.append(_params(p2))
        moments.append(_moments(p2))
        assert p2.encoder.training and p2.decoder.training     # the modes given back
    jp2 = _jax_side()
    states = [_jax_state(*trees)]
    jax_metrics = []
    with pytest.MonkeyPatch.context() as mp:
        _feed_jax(jp2, rec, mp)
        ep, dp = trees
        for i in range(2):
            out = jp2.run(ep, dp, _z_cache(), jax.random.PRNGKey(i), phase2_weight=0.1,
                          current_exact=0.9)
            ep, dp = (jax.tree.map(np.asarray, out[k]) for k in ('enc_params', 'dec_params'))
            jax_metrics.append(out['metrics'])
            states.append(_jax_state(ep, dp, jp2))
    return dict(p2=p2, jp2=jp2, before=before, moments=moments, port=port_metrics,
                jax=jax_metrics, states=states, rec=rec, trees=trees)


def test_greedy_half_equals_jax_greedy(two_sub_epochs):
    """(a) The first sub-epoch's greedy half against JAX's own greedy
    rollout of the same latents from the same weights (JAX's conditioning
    from its own jitted heads)."""
    rec, trees, jp2 = (two_sub_epochs[k] for k in ('rec', 'trees', 'jp2'))
    z, tokens = rec['z'][0].numpy(), rec['tokens'][0]
    n_greedy = P2['n_samples'] // 2
    heads = jp2._heads_fn(trees[0], jnp.asarray(z))
    want = jax_generate(JaxDecoder(jax_config(CFG)), trees[1], jnp.asarray(z[:n_greedy]),
                        heads['stoich'][:n_greedy], heads['heads_vec'][:n_greedy],
                        jax.random.PRNGKey(0), JaxGenConfig(max_len=CFG.max_len, temperature=0.0))
    np.testing.assert_array_equal(tokens[:n_greedy].numpy(), np.asarray(want['tokens']))
    assert tokens.shape == (P2['n_samples'], CFG.max_len - 1)


@pytest.mark.parametrize('i', [0, 1])
def test_sub_epoch_metrics_equal_jax(two_sub_epochs, i):
    got, want = two_sub_epochs['port'][i], two_sub_epochs['jax'][i]
    assert got['n_accepted'] > 0, 'the tiny model emitted only empty strings'
    for k in ('loss1_round_trip', 'loss2_consistency', 'loss3_physics', 'loss4_reinforce',
              'round_trip_z_mse', 'tc_mse', 'phase2_loss'):
        assert k in got and np.isfinite(got[k]), k
    _check_metrics(got, want)


@pytest.mark.parametrize('i', [0, 1])
def test_sub_epoch_moments_and_updates_equal_jax(two_sub_epochs, i):
    r = two_sub_epochs
    check_moments_and_updates(r['before'][i], r['before'][i + 1], r['moments'][i],
                              r['states'][i], r['states'][i + 1], BASE_LR * 0.1,
                              ADAMW_WEIGHT_DECAY, i + 1, names=('enc', 'dec'))
    # both models moved
    for g in range(2):
        assert any(not np.array_equal(r['before'][i][g][k], r['before'][i + 1][g][k])
                   for k in r['before'][i][g])


def test_sub_epoch_state_equals_jax(two_sub_epochs):
    p2, jp2 = two_sub_epochs['p2'], two_sub_epochs['jp2']
    _coverage_equal(p2.coverage, jp2.coverage)
    assert [d['formula'] for d in p2.tracker.discoveries] == [
        d['formula'] for d in jp2.tracker.discoveries]
    assert p2._rewarded == jp2._rewarded and p2._epoch == jp2._epoch == 2
    assert p2._collapse_remaining == jp2._collapse_remaining
    for opt in (p2._enc_opt, p2._dec_opt):
        assert opt.defaults['weight_decay'] == ADAMW_WEIGHT_DECAY
        assert opt.defaults['lr'] == pytest.approx(BASE_LR * 0.1)


# -- (c) the real validators, (d) the collapse intervention and the guards -----------

def test_real_validators_and_collapse_equal_jax(monkeypatch):
    """Three sub-epochs on fixed rollouts: the corpus-like FORMULAS under the
    real validators (accepted set, candidate quality through the coverage
    state, novel discoveries), then, with the permissive validators, one
    formula 16 times (a collapse) and the sub-epoch after it (temperature
    boost, round-trip weight doubled); each against JAX fed the same."""
    trees = param_trees(CFG)
    p2, rec = _port_side(trees, permissive=False)
    streams = [_fixed_tokens(FORMULAS), _fixed_tokens(['MgB2'] * 16),
               _fixed_tokens(FORMULAS[::-1])]
    fixed = iter(streams)
    rollouts = p2.rollouts
    p2.rollouts = lambda *a: (rollouts(*a), next(fixed))[1]
    jp2 = _jax_side(permissive=False)
    outs, jouts = [], []
    gen = torch.Generator().manual_seed(2)
    for i in range(3):
        outs.append(p2.run(_z_cache(), gen, phase2_weight=0.1))
        rec['tokens'][i] = streams[i]
        if i == 0:
            p2.validator = p2.physics = _Accept()
    _feed_jax(jp2, rec, monkeypatch)
    ep, dp = trees
    for i in range(3):
        out = jp2.run(ep, dp, _z_cache(), jax.random.PRNGKey(i), phase2_weight=0.1)
        ep, dp = out['enc_params'], out['dec_params']
        jouts.append(out)
        if i == 0:
            jp2.validator = jp2.physics = _Accept()
        assert outs[i]['accepted'] == out['accepted']
        _check_metrics(outs[i]['metrics'], out['metrics'],
                       skip=('explore_temp',) if i < 2 else ())
    real = outs[0]
    assert 0 < real['metrics']['n_accepted'] < len(FORMULAS)
    assert {'MgB2', 'Nb3Sn', 'YBa2Cu3O7'} <= set(real['accepted'])
    assert not {'He', 'Cu60O3', 'TlF'} & set(real['accepted'])
    _coverage_equal(p2.coverage, jp2.coverage)
    assert [d['formula'] for d in p2.tracker.discoveries] == [
        d['formula'] for d in jp2.tracker.discoveries]
    # the collapse and the sub-epoch after it
    assert outs[1]['metrics']['mode_collapsed'] and outs[1]['metrics']['collapse_active']
    assert outs[2]['metrics']['explore_temp'] == p2.cfg.collapse_temp_boost
    assert outs[2]['metrics']['collapse_active']
    # the exact-drop guard halves the weight
    p2._exact_hist = [0.9, 0.9, 0.9, 0.9]
    assert p2._safety_weight(0.1, 0.5) == pytest.approx(0.05)
    jp2._exact_hist = [0.9, 0.9, 0.9, 0.9]
    assert p2._safety_weight(0.1, 0.85) == jp2._safety_weight(0.1, 0.85) == 0.05


def test_no_accepted_candidate_leaves_the_models():
    """Only empty formulas: no update and no optimizer, the metrics of the
    early return; likewise at a weight of 0."""
    p2, _ = _port_side(param_trees(CFG))
    before = _params(p2)
    p2.rollouts = lambda *a: torch.zeros(P2['n_samples'], CFG.max_len - 1, dtype=torch.long)
    out = p2.run(_z_cache(), torch.Generator().manual_seed(3))
    assert out['metrics']['n_accepted'] == 0 and 'phase2_loss' not in out['metrics']
    p2.rollouts = lambda *a: _fixed_tokens(FORMULAS)
    out = p2.run(_z_cache(), torch.Generator().manual_seed(3), phase2_weight=0.0)
    assert out['metrics']['n_accepted'] == 16 and 'phase2_loss' not in out['metrics']
    assert p2._enc_opt is None
    after = _params(p2)
    assert all(np.array_equal(before[g][k], after[g][k]) for g in range(2) for k in before[g])
    assert p2.coverage.visits.sum() > 0


# -- train(), the training CLI and the standalone CLI ---------------------------------

def test_train_runs_phase2_every_epoch(tmp_path, monkeypatch, capsys):
    tc = TrainConfig(num_epochs=2, batch_size=16, max_formula_len=CFG.max_len,
                     use_physics_z=False, hungarian_enabled=False, use_round_trip=False,
                     eval_interval=1, phase2_enabled=True, phase2_auto_min_exact=0.0,
                     phase2_interval=1, phase2_n_samples=16)
    out = train(model_config=CFG, train_config=tc, output_dir=tmp_path, limit=48,
                log_fn=lambda *a: None, device='cpu')
    assert len(out['history']) == 2
    lines = [json.loads(x) for x in (tmp_path / 'phase2_log.jsonl').read_text().splitlines()]
    assert [r['epoch'] for r in lines] == [0, 1]
    assert all(r['n_sampled'] == 16 for r in lines)
    assert lines[0]['phase2_weight'] == pytest.approx(tc.phase2_max_weight / tc.phase2_warmup)
    # the JAX repo's dashboard (no JAX, no package) reads the port's log
    monkeypatch.setattr(sys, 'argv', ['phase2_dashboard.py', str(tmp_path)])
    runpy.run_path(str(ROOT / 'scripts/phase2_dashboard.py'), run_name='__main__')
    assert 'sub-epoch' in capsys.readouterr().out.lower()


def test_training_cli_takes_run4_flags(tmp_path):
    """launch_run4.sh's flags with --tiny --synthetic --cpu; a second call
    opens Phase 2's gate at every epoch, in bf16 compute as run4 ran it."""
    run4 = ['--bf16', '--set', 'lr_warmup_epochs=0', '--set', 'rl_epoch_interval=3',
            '--set', 'phase2_enabled=true', '--set', 'phase2_interval=16',
            '--set', 'eval_interval=8']
    base = ['--cpu', '--tiny', '--synthetic', '--limit', '32', '--batch-size', '16',
            '--set', 'hungarian_enabled=false', '--set', 'use_round_trip=false']
    out = train_cli.main(base + run4 + ['--epochs', '2', '--output', str(tmp_path / 'a')])
    assert len(out['history']) == 2 and not (tmp_path / 'a/phase2_log.jsonl').exists()
    out = train_cli.main(base + run4 + [
        '--epochs', '1', '--output', str(tmp_path / 'b'), '--set', 'phase2_interval=1',
        '--set', 'phase2_auto_min_exact=0', '--set', 'phase2_n_samples=16'])
    assert out['encoder'].dtype == torch.bfloat16
    rec = json.loads((tmp_path / 'b/phase2_log.jsonl').read_text())
    assert rec['n_accepted'] > 0 and np.isfinite(rec['phase2_loss'])


def test_phase2_standalone_saves_a_loadable_checkpoint(tmp_path):
    ds = load_dataset(CSV, max_len=CFG.max_len, limit=64, skew_transform='rank_gauss')
    mcfg = dataclasses.replace(CFG, magpie_dim=ds.magpie_dim)
    tc = TrainConfig(max_formula_len=CFG.max_len, use_physics_z=False,
                     skew_transform='rank_gauss')
    state = create_train_state(mcfg, tc, device='cpu')
    src = save_checkpoint(tmp_path / 'ckpt', state, mcfg, tc, epoch=3,
                          controllers={'last_ar_exact': 0.5})
    out = phase2_standalone.main([
        '--checkpoint', str(src), '--csv', str(CSV), '--cpu', '--limit', '64',
        '--sub-epochs', '1', '--n-samples', '16', '--out-dir', str(tmp_path / 'p2'),
        '--save-checkpoint', str(tmp_path / 'saved')])
    log = [json.loads(x) for x in (tmp_path / 'p2/phase2_log.jsonl').read_text().splitlines()]
    assert [r['sub_epoch'] for r in log] == [0] and log[0]['metrics']['n_sampled'] == 16
    summary = json.loads((tmp_path / 'p2/phase2_summary.json').read_text())
    assert summary['sub_epochs'] == 1 and summary['n_samples'] == 16
    restored, meta = load_checkpoint(tmp_path / 'saved')
    assert meta['phase2'] == summary and meta['epoch'] == 3
    assert not any(k.endswith('_opt') for k in restored)
    for key, module in (('enc_params', out['encoder']), ('dec_params', out['decoder'])):
        live = module.state_dict()
        assert restored[key].keys() == live.keys()
        assert all(torch.equal(restored[key][k], live[k]) for k in live), key
    # --params needs --meta
    with pytest.raises(SystemExit):
        phase2_standalone.main(['--params', 'x.npz'])
