"""Data parallelism in the port (parallel/, the train step's global-batch
shares, ``train()`` over ranks) on gloo ranks on the CPU: the steps through
scripts/dryrun_multichip.py ``run_dp`` (rank 0 also runs the one-process
step from the same state), ``train()`` through
tests/torch_port_dist_worker.py.

The global batch is 8 corpus rows (tests/test_torch_port_train_step.py's)
ordered so that the shards differ in token count and in superconductor
rows, with the round trip's one row (max(int(0.1 * 8), 1)) on rank 0.
- The data-parallel step at 2 ranks, through ``make_train_step`` and
  through ``make_epoch_runner``, and at 4 ranks through the step alone,
  at ``TrainConfig()``'s defaults (the
  set decoder, the round trip, the learnable physics-Z projection;
  ``physz_w`` 1, dropout 0 in every model) against the one-process step
  on the whole batch: every metric, the 17 terms among them, within 1e-5
  relative, but the gradient norm within 1e-4 (a norm of the sum of the
  shards' float32 gradients, in another order than one pass sums them);
  every group's AdamW moments (the summed, clipped gradients)
  within 1e-5 of the group's largest; every parameter change equal to
  the AdamW rule on the step's own moments (float64, 1.5 float32 ulp and
  1e-5 of the update), and within 2e-3 of lr and 1.5 ulp of the
  one-process change wherever the moments agree to 1e-3 (at least 95% of
  the elements: AdamW's first step turns the noise of a near-zero
  gradient into a sign); and every rank's parameters and moments equal
  bit for bit.
- At 2 ranks also with SupCon on (a differentiable all-gather of z) and
  an RLOO step (the rollout sampled over the gathered global batch on
  every rank), against the one-process step, as above.
- The same at 2 ranks against JAX's single-device step from the same
  parameters (``params_from_jax``), without the set decoder and the round
  trip (one JAX compile): the metrics and the moments and updates at
  tests/test_torch_port_train_step.py's tolerances.
- A SIGINT on rank 1 stops both ranks after the epoch, with one
  'interrupt' checkpoint, rank 0's.
- ``train()`` at 2 ranks for 2 epochs (the second SCST) in two calls, the
  second resuming from the first's checkpoint, against the one-process
  run: one metrics CSV and one checkpoint an epoch (rank 0's), the
  last the final state, every history row's
  losses within 1e-4 relative and its other columns equal, the final
  parameters within 2e-3 of lr a step plus 2.5 ulp a step wherever the
  moments agree to 1e-3 (at least 95% of the elements), but for at most
  1 in 1,000 of them within 5 times that.
"""

import csv
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.ops.physics_z_loss import init_magpie_proj as jax_init_proj
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import train_step as jts
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.checkpoint import load_checkpoint
from superconductor_vae_tpu_torch.data import synthetic_dataset
from superconductor_vae_tpu_torch.models import SetDecoderLayer, tiny_test_config
from superconductor_vae_tpu_torch.ops.losses import LossConfig
from superconductor_vae_tpu_torch.ops.rl import RLConfig
from superconductor_vae_tpu_torch.scripts import dryrun_multichip
from superconductor_vae_tpu_torch.training import (
    TrainConfig, create_train_state, default_dyn, train)
import torch_port_dist_worker as worker
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_train_step import (
    MET_TOL, TCFG, _batches, _port_state, _to_torch, check_moments_and_updates)
from torch_port_common import jax_config, param_trees

ROOT = Path(__file__).resolve().parent.parent
CFG = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0)
# the 8 rows in the global batch's order: rank 0 of 2 holds 28 target
# tokens and 1 SC row, rank 1 42 tokens and 4 SC rows
ORDER = [0, 1, 5, 2, 3, 4, 6, 7]
DP_TOL = dict(rtol=1e-5, atol=1e-7)
CASES = ('defaults', 'light', 'supcon', 'rloo')
# the light case with SupCon on (it needs the whole batch's z: a
# differentiable all-gather), and with an RLOO step (its rollout samples the
# gathered global batch from one generator on every rank)
_SUPCON = dict(TCFG, loss=LossConfig(supcon_weight=0.5))
_RLOO = dict(TCFG, rl=RLConfig(method='rloo', n_samples_rloo=2, max_len=CFG.max_len))


def _global_batch():
    b1, b2 = _batches(CFG)
    full = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
    return {k: v[ORDER] for k, v in full.items()}


def _defaults_state(cfg=CFG):
    """``TrainConfig()``'s state at tiny widths (``cfg``), the set decoder
    without dropout (its own default is 0.1)."""
    tc = TrainConfig()
    state = create_train_state(cfg, tc, seed=0, device='cpu')
    for layer in state.set_decoder.children():
        if isinstance(layer, SetDecoderLayer):
            layer.dropout = 0.0
    return state, tc


@pytest.fixture(scope='module')
def runs():
    """The data-parallel steps at 2 and 4 ranks on the same global batch,
    each against the one-process step that rank 0 runs from the same state
    (scripts/dryrun_multichip.py ``start_dp``), the dryrun CLI at 2 ranks,
    and, while they run, JAX's step (light case)."""
    batch_np = _global_batch()
    enc_np, dec_np = param_trees(CFG, seed=0)
    pz_np = jax.tree.map(np.asarray, jax_init_proj(jax.random.PRNGKey(3), CFG.magpie_dim))
    jtc = JaxTrainConfig(**TCFG)
    tx_enc, tx_dec = jts.make_optimizer(jtc), jts.make_optimizer(jtc)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), enc_params=enc_np, dec_params=dec_np,
        enc_opt=tx_enc.init(enc_np), dec_opt=tx_dec.init(dec_np),
        pz_params=pz_np, pz_opt=tx_enc.init(pz_np))
    prev = jax.tree.map(np.asarray, jstate)

    states = {'defaults': _defaults_state()}
    for name, kw in (('light', TCFG), ('supcon', _SUPCON), ('rloo', _RLOO)):
        tc = TrainConfig(**kw)
        states[name] = (_port_state(prev, CFG, tc), tc)
    cases = []
    for name in CASES:
        state, tc = states[name]
        rl = name == 'rloo'
        dyn = dict(default_dyn(tc), physz_w=1.0, rl_w=1.0 if rl else 0.0)
        cases.append(dryrun_multichip.dp_case(state, tc, dyn, rl, paths=('step', 'runner')))
    job = dict(batches=[_to_torch(batch_np)], max_len=CFG.max_len, seed=0, snapshots=True)
    dp = {2: dryrun_multichip.start_dp(dict(job, cases=cases), 2),
          # 4 ranks for the step alone
          4: dryrun_multichip.start_dp(dict(job, cases=[dict(cases[0], paths=('step',))]), 4)}
    cli = subprocess.Popen(
        [sys.executable, '-m', 'superconductor_vae_tpu_torch.scripts.dryrun_multichip', '2'],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # JAX's single-device step, light case
    jcfg = jax_config(CFG)
    jstep = jts.make_train_step(JaxEncoder(jcfg), JaxDecoder(jcfg), jtc, tx_enc, tx_dec,
                                jts.build_luts(jax_tokenizer(max_len=CFG.max_len)),
                                donate=False)
    jdyn = dict(jts.default_dyn(jtc), physz_w=jnp.asarray(1.0, jnp.float32))
    jnext, jmetrics = jstep(jstate, batch_np, jax.random.PRNGKey(0), jdyn)
    jax_run = dict(prev=prev, next=jax.tree.map(np.asarray, jnext),
                   metrics=jax.tree.map(np.asarray, jmetrics), lr=jtc.learning_rate,
                   wd=jtc.weight_decay)
    return dict(batch=batch_np, jax=jax_run, dp={w: finish() for w, finish in dp.items()},
                cli=(cli.communicate()[0], cli.returncode), tc={n: states[n][1] for n in CASES},
                before={n: dryrun_multichip.snapshot(states[n][0]) for n in CASES})


def _result(runs, world, case, path, rank=0):
    """One rank's record of the step: its ``metrics``; on rank 0 also its
    ``snapshot`` and the one-process step's ``want`` and ``one`` (its
    snapshot)."""
    return runs['dp'][world][rank]['cases'][CASES.index(case)][path]['steps'][0]


def test_shards_differ_and_the_round_trip_is_on_rank_0():
    batch = _global_batch()
    for world in (2, 4):
        shards = np.split(np.arange(8), world)
        tokens = [(batch['tokens'][s] != 0).sum() for s in shards]
        sc = [batch['is_sc'][s].sum() for s in shards]
        assert len(set(tokens)) > 1 and len(set(sc)) > 1, (world, tokens, sc)
    assert max(int(8 * TrainConfig().round_trip_subset_fraction), 1) <= 8 // 4


def _close_state(got, want, before, tc, what):
    """Moments within 1e-5 of each group's largest; each parameter change
    the AdamW rule on the step's own moments (float64, 1.5 ulp and 1e-5 of
    the update) and, wherever the moments agree with the one-process
    step's to 1e-3 (at least 95% of the elements), within 2e-3 of lr and
    1.5 ulp of its change."""
    lr, wd = tc.learning_rate, tc.weight_decay
    b1, b2 = 0.9, 0.999
    for g, (got_g, want_g, before_g) in enumerate(zip(got, want, before)):
        scale_m = max(np.abs(w[1]).max() for w in want_g)
        scale_v = max(np.abs(w[2]).max() for w in want_g)
        n_agree = n_all = 0
        for (p, m, v), (wp, wm, wv), (p0, _, _) in zip(got_g, want_g, before_g):
            np.testing.assert_allclose(m, wm, rtol=1e-5, atol=1e-5 * scale_m,
                                       err_msg=f'{what}: group {g} exp_avg')
            np.testing.assert_allclose(v, wv, rtol=1e-5, atol=1e-5 * scale_v,
                                       err_msg=f'{what}: group {g} exp_avg_sq')
            ulp = np.finfo(np.float32).eps * np.abs(p0)
            m64, v64 = m.astype(np.float64) / (1 - b1), v.astype(np.float64) / (1 - b2)
            rule = -lr * (m64 / (np.sqrt(v64) + 1e-8) + wd * p0)
            assert (np.abs((p - p0) - rule) <= 1.5 * ulp + 1e-5 * np.abs(rule) + 1e-12).all(), \
                f'{what}: group {g} AdamW rule'
            agree = np.abs(m - wm) <= 1e-3 * np.abs(wm)
            off = np.abs((p - p0) - (wp - p0)) > 2e-3 * lr + 1.5 * ulp
            assert not (off & agree).any(), f'{what}: group {g} update'
            n_agree += agree.sum()
            n_all += agree.size
        assert n_agree >= 0.95 * n_all, (what, g, n_agree, n_all)


@pytest.mark.parametrize('world,case,path', [
    (w, c, p) for c in CASES for p in ('step', 'runner') for w in (2, 4)
    if w == 2 or (c, p) == ('defaults', 'step')])
def test_dp_step_matches_the_one_process_step(runs, world, case, path):
    rec = _result(runs, world, case, path)
    metrics, before, after = rec['want'], runs['before'][case], rec['one']
    got_metrics, got_state = rec['metrics'], rec['snapshot']
    assert set(got_metrics) == set(metrics)
    for key in ('a5_z_mse', 'hungarian_loss', 'physics_z_loss', 'formula_loss')[
            0 if case == 'defaults' else 2:]:
        assert key in metrics, key
    if case == 'rloo':
        assert metrics['mean_reward'] != 0.0 and 'reward_var' in metrics
    if case == 'supcon':
        # SupCon is in the total: it differs from the light case's
        assert metrics['total'] != _result(runs, world, 'light', path)['want']['total']
    for key, want in metrics.items():
        tol = MET_TOL if key == 'grad_norm' else DP_TOL
        np.testing.assert_allclose(got_metrics[key], want, **tol, err_msg=key)
    _close_state(got_state, after, before, runs['tc'][case], f'{world} ranks, {case}')
    # every rank took the same update
    for r in range(1, world):
        assert _result(runs, world, case, path, rank=r)['metrics'] == got_metrics
        assert runs['dp'][world][r]['cases'][CASES.index(case)][path]['same_as_rank0']


def test_dp_step_matches_jax(runs):
    """The 2-rank step against JAX's single-device step on the whole
    batch (no set decoder and no round trip)."""
    j = runs['jax']
    rec = _result(runs, 2, 'light', 'step')
    got_metrics, got_state = rec['metrics'], rec['snapshot']
    assert set(got_metrics) == set(j['metrics'])
    for key in j['metrics']:
        np.testing.assert_allclose(got_metrics[key], j['metrics'][key], **MET_TOL,
                                   err_msg=key)
    before = runs['before']['light']
    names = ('enc', 'dec', 'pz')
    state = _port_state(j['prev'], CFG, TrainConfig(**TCFG))
    keys = [[n for n, _ in m.named_parameters()]
            for m in (state.encoder, state.decoder, state.pz_proj)]
    as_dicts = lambda snap, col: [  # noqa: E731
        {k: t[col] for k, t in zip(ks, grp)} for ks, grp in zip(keys, snap)]
    moments = [{k: (t[1], t[2]) for k, t in zip(ks, grp)} for ks, grp in zip(keys, got_state)]
    check_moments_and_updates(as_dicts(before, 0), as_dicts(got_state, 0), moments,
                              j['prev'], j['next'], j['lr'], j['wd'], 1, names=names)


# -- train() over two ranks ---------------------------------------------------------

SYNTH = dict(max_len=16, magpie_dim=16)
_TRAIN = dict(batch_size=16, max_formula_len=16, hungarian_enabled=False,
              learning_rate=1e-3, checkpoint_interval=1, rl_weight=0.0,
              rl_reactivation_min_exact=0.0, rl_reactivation_window=2,
              rl_reactivation_force_exact=1.0, rl_min_ar_exact=0.0, rl_epoch_interval=2,
              rl=RLConfig(max_len=16))
_LOSSES = ('total', 'formula_loss', 'tc_loss', 'exact_match', 'token_accuracy', 'entropy',
           'mean_reward')
_TIMING = ('epoch_time_s', 'samples_per_s')


def _rows(history):
    return [{k: v for k, v in r.items() if k not in _TIMING} for r in history]


def _close_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(_rows(got), _rows(want)):
        assert g.keys() == w.keys()
        for k in g:
            if k in _LOSSES:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6, err_msg=k)
            else:
                assert g[k] == w[k], k


def _close_params(got, want, lr, steps):
    """Wherever the moments agree to 1e-3 (at least 95% of the elements),
    parameter values within 2e-3 of lr a step plus 2.5 ulp a step, but
    for at most 1 in 1,000 within 5 times that (an earlier near-zero
    gradient's sign, carried on)."""
    for got_g, want_g in zip(got, want):
        n_ok = n_all = n_off = 0
        for (p, m, _), (wp, wm, _) in zip(got_g, want_g):
            agree = np.abs(m - wm) <= 1e-3 * np.abs(wm) + 1e-12
            tol = steps * (2e-3 * lr + 2.5 * np.finfo(np.float32).eps * np.abs(wp))
            diff = np.abs(p - wp)
            assert (diff <= 5 * tol)[agree].all()
            n_off += ((diff > tol) & agree).sum()
            n_ok += agree.sum()
            n_all += agree.size
        assert n_ok >= 0.95 * n_all, (n_ok, n_all)
        assert n_off <= 1e-3 * n_ok, (n_off, n_ok)


@pytest.fixture(scope='module')
def train_runs(tmp_path_factory):
    """The one-process train() for 2 epochs; at 2 ranks, train() for the
    first epoch, then a second call that resumes from its checkpoint, and
    a run that rank 1 interrupts (the ranks run while the one process
    does)."""
    ds = synthetic_dataset(n=32, **SYNTH)
    job = tmp_path_factory.mktemp('dp_train')
    torch.save({'mcfg': CFG, 'dataset': ds,
                'tc_first': TrainConfig(**dict(_TRAIN, num_epochs=1)),
                'tc_rest': TrainConfig(**dict(_TRAIN, num_epochs=2, resume='auto'))},
               job / 'inputs.pt')
    wait = dryrun_multichip.spawn(worker.dp_train, 2, job)
    tc = TrainConfig(**dict(_TRAIN, num_epochs=2))
    single_dir = tmp_path_factory.mktemp('single')
    single = train(model_config=CFG, train_config=tc, dataset=ds, output_dir=single_dir,
                   log_fn=lambda *a, **k: None, device='cpu')
    wait()
    return dict(single=single, single_dir=single_dir, out=job / 'run', job=job,
                ranks=[torch.load(job / f'rank{r}.pt', weights_only=False) for r in (0, 1)])


def test_train_over_two_ranks_matches_one_process(train_runs):
    """The first call (one TF epoch): its history, one CSV and one
    checkpoint, rank 0's, as the one-process run's first epoch."""
    single, out = train_runs['single'], train_runs['out']
    assert [r['rl_weight'] > 0 for r in single['history']] == [False, True]
    assert single['history'][1]['mean_reward'] != 0.0
    for rank in (0, 1):
        _close_rows(train_runs['ranks'][rank]['first'], single['history'][:1])
    assert [p.relative_to(out).as_posix() for p in out.glob('**/training_metrics.csv')] == [
        'training_metrics.csv']
    got, meta = load_checkpoint(out / 'checkpoints' / 'epoch_00000')
    want, want_meta = load_checkpoint(train_runs['single_dir'] / 'checkpoints' / 'epoch_00000')
    assert meta['epoch'] == want_meta['epoch'] == 0 and got['step'] == want['step'] == 2
    assert got.keys() == want.keys()


def test_train_resumed_over_two_ranks_matches_one_process(train_runs):
    """The resumed call (the SCST epoch): its history, the final state, the
    appended CSV and the checkpoints as the one-process run's; the last
    checkpoint is the run's final state."""
    single, out = train_runs['single'], train_runs['out']
    lr = _TRAIN['learning_rate']
    want_state = dryrun_multichip.snapshot(single['state'])
    for rank in (0, 1):
        history, state = train_runs['ranks'][rank]['rest']
        assert [r['epoch'] for r in history] == [1]
        _close_rows(history, single['history'][1:])
        _close_params(state, want_state, lr, steps=4)
    rows = list(csv.DictReader(open(out / 'training_metrics.csv')))
    want_rows = list(csv.DictReader(open(train_runs['single_dir'] / 'training_metrics.csv')))
    assert [r['epoch'] for r in rows] == [r['epoch'] for r in want_rows] == ['0', '1']
    assert (sorted(p.name for p in (out / 'checkpoints').iterdir())
            == sorted(p.name for p in (train_runs['single_dir'] / 'checkpoints').iterdir()))
    got, meta = load_checkpoint(out / 'checkpoints' / 'epoch_00001')
    assert meta['epoch'] == 1 and got['step'] == 4
    for group, params in train_runs['ranks'][0]['rest_params'].items():
        assert got[group].keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_array_equal(got[group][k].numpy(), v, err_msg=k)


def test_dryrun_multichip_two_ranks(runs):
    """scripts/dryrun_multichip.py at 2 gloo ranks: the DP arm and the
    epoch-runner arm against the one-process step; the TP arm needs 4."""
    out, rc = runs['cli']
    assert rc == 0, out
    assert 'dryrun_multichip(2, gloo): OK' in out and 'TP arm skipped: n_model=1' in out


def test_train_signal_on_one_rank_stops_every_rank_with_one_save(train_runs):
    """SIGINT on rank 1 during epoch 0: both ranks stop after it, and rank 0
    saves one 'interrupt' checkpoint (and the epoch's periodic one)."""
    cut = train_runs['job'] / 'cut'
    for rank in (0, 1):
        assert [r['epoch'] for r in train_runs['ranks'][rank]['cut']] == [0]
    assert sorted(p.name for p in (cut / 'checkpoints').iterdir()) == [
        'epoch_00000', 'interrupt']
    _, meta = load_checkpoint(cut / 'checkpoints' / 'interrupt')
    assert meta['epoch'] == 0
