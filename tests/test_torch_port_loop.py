"""The host loop of the port: the whole ``train()`` against the JAX package, and the port's own guarantees
(the epoch runner, checkpoints, resume, refusals, the CLI).

Against JAX (gradient accumulation is held to optax ``MultiSteps`` in
tests/test_torch_port_loop_parts.py): one ``train()`` call of each package, 2 epochs on
  ``synthetic_dataset(n=64)`` at batch 16 with dropout 0 and the per-batch
  input path, the port started from JAX's initial parameters: every
  history row's losses and accuracies within 1e-4 relative, its
  learning rate and weights equal; the per-row true-AR exact match equal
  except for rows whose top-two logit gap came within 1e-4 (counted); the
  final AdamW moments as above, and the parameter changes within 2e-3 of
  lr a step (AdamW's step is at most about lr, and the two-step test holds
  one step's change to 2e-3 of it) plus 2.5 float32 ulp a step, wherever
  the moments agree to 1e-3, which must be at least 95% of the elements.

The port alone, bit for bit: the epoch runner against the per-step path;
a checkpoint's save and load, the set decoder's parameters and optimizer
included; a run stopped by SIGINT after its second epoch and resumed from
its checkpoint against an uninterrupted one, with dropout on, gradient
accumulation across the save, an RL epoch after it, and the set decoder
and the round-trip loss on (``TrainConfig()``'s defaults; the set decoder
at tiny widths here, ``_DEFAULTS``).
"""

import csv
import dataclasses
import json
import signal

import jax
import numpy as np
import pytest
import torch

import superconductor_vae_tpu.training.train_loop as jax_loop_mod
import superconductor_vae_tpu_torch.training.train_loop as loop_mod
from superconductor_vae_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.checkpoint import (
    latest_checkpoint, load_checkpoint, params_from_jax, save_checkpoint)
from superconductor_vae_tpu_torch.data import synthetic_dataset
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.ops.rl import RLConfig
from superconductor_vae_tpu_torch.scripts import train as cli
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    TrainConfig, TrainState, build_luts, create_train_state, default_dyn, make_epoch_runner,
    make_train_step, train)
from superconductor_vae_tpu_torch.training.evaluate import _to_device
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_train_step import _adam_states, _leaves, _port_moments, _tree_close
from torch_port_common import jax_config

TIE = 1e-4
SYNTH = dict(max_len=16, magpie_dim=16)
_LOOP = dict(batch_size=16, max_formula_len=16, use_physics_z=False,
             hungarian_enabled=False, use_round_trip=False, learning_rate=1e-3)
# the set decoder and the round-trip loss on, as TrainConfig() has them, with
# the set decoder as narrow as the tiny model
_DEFAULTS = dict(hungarian_enabled=True, use_round_trip=True, hungarian_d_model=32,
                 hungarian_num_layers=2, hungarian_dim_feedforward=64)


def _quiet(*a, **k):
    pass


# -- the whole loop against JAX's train() ---------------------------------------

class _Recorder:
    """Stands in for a loop module's ``evaluate_autoregressive`` and keeps
    each result."""

    def __init__(self, fn):
        self.fn, self.outputs = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.outputs.append(out)
        return out


def test_train_matches_jax_train(tmp_path, monkeypatch):
    cfg = dataclasses.replace(tiny_test_config(), dropout=0.0)
    kw = dict(_LOOP, num_epochs=2, eval_interval=2, device_resident_data=False)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    # JAX's initial parameters, with the stop head turned to rise along a
    # rollout and the type head kept from EOS, so that the eval's greedy
    # rollouts run several steps; both packages start from them
    real_create = jax_loop_mod.create_train_state
    _, _, jstate0, _, _ = real_create(jax_config(cfg), jtc, jax.random.PRNGKey(jtc.seed))
    init = [jax.tree.map(np.array, t) for t in (jstate0.enc_params, jstate0.dec_params)]
    dec = init[1]['params']
    dec['stop_d2']['kernel'] *= -1
    dec['stop_d2']['bias'][:] = 2.2
    dec['type_d3']['bias'][:] = [0.0, 0.0, 0.0, -3.0, -3.0]

    def jax_create(*args, **kwargs):
        encoder, decoder, state, tx_enc, tx_dec = real_create(*args, **kwargs)
        return encoder, decoder, state.replace(enc_params=init[0], dec_params=init[1]), \
            tx_enc, tx_dec
    monkeypatch.setattr(jax_loop_mod, 'create_train_state', jax_create)
    jax_rec = _Recorder(jax_loop_mod.evaluate_autoregressive)
    monkeypatch.setattr(jax_loop_mod, 'evaluate_autoregressive', jax_rec)
    want = jax_loop_mod.train(model_config=jax_config(cfg), train_config=jtc,
                              dataset=jax_synthetic(n=64, **SYNTH), output_dir=tmp_path / 'jax',
                              use_mesh=False, log_fn=_quiet)

    # the port from the same parameters, with fresh optimizers
    def from_jax(mcfg, tcfg, seed=0, device='cuda'):
        enc, dec = params_from_jax(*init, mcfg, device=device)
        return TrainState.from_modules(enc, dec, tcfg)
    monkeypatch.setattr(loop_mod, 'create_train_state', from_jax)
    rec = _Recorder(loop_mod.evaluate_autoregressive)
    monkeypatch.setattr(loop_mod, 'evaluate_autoregressive', rec)
    got = train(model_config=cfg, train_config=tc, dataset=synthetic_dataset(n=64, **SYNTH),
                output_dir=tmp_path / 'port', log_fn=_quiet, device='cpu')

    assert len(got['history']) == len(want['history']) == 2
    for g, w in zip(got['history'], want['history']):
        assert set(g) == set(w)
        for k in ('total', 'formula_loss', 'tc_loss', 'exact_match', 'token_accuracy'):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7, err_msg=k)
        for k in ('epoch', 'lr', 'rl_weight', 'physz_weight'):
            assert g[k] == w[k], k
    # the one eval (the last epoch), row by row
    assert len(rec.outputs) == len(jax_rec.outputs) == 1
    e, je = rec.outputs[0], jax_rec.outputs[0]
    np.testing.assert_array_equal(e['sample_indices'], je['sample_indices'])
    differ = e['per_sample_ar_exact'] != je['per_sample_ar_exact']
    near = e['per_sample_margin'] < TIE
    print(f'per-row AR exact: {int(differ.sum())} rows differ, {int(near.sum())} rows within '
          f'a top-two gap of {TIE} (min gap {e["per_sample_margin"].min():.3e}); '
          f'{int(e["per_sample_ar_exact"].sum())} exact; mean AR exact {e["ar_exact"]}')
    assert not (differ & ~near).any()
    if not differ.any():
        assert got['history'][-1]['true_ar_exact'] == want['history'][-1]['true_ar_exact']

    # the final parameters and AdamW moments (8 steps)
    js = want['state']
    port_params = [{k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
                   for m in (got['encoder'], got['decoder'])]
    moments = _port_moments(got['state'])
    steps = int(js.step)
    assert got['state'].step == steps == 8
    eps = np.finfo(np.float32).eps
    for g, name in enumerate(('enc', 'dec')):
        adam = _adam_states(getattr(js, f'{name}_opt'))
        want_mu, want_nu = _leaves(adam.mu), _leaves(adam.nu)
        got_mu = {k: v[0] for k, v in moments[g].items()}
        got_nu = {k: v[1] for k, v in moments[g].items()}
        _tree_close(got_mu, want_mu, f'{name} mu')
        _tree_close(got_nu, want_nu, f'{name} nu')
        start = _leaves(init[g])
        end = _leaves(getattr(js, f'{name}_params'))
        checked = total = 0
        worst = 0.0
        for k, p0 in start.items():
            got_d, want_d = port_params[g][k] - p0, end[k] - p0
            same = ((np.abs(got_mu[k] - want_mu[k]) <= 1e-3 * np.abs(want_mu[k]))
                    & (np.abs(got_nu[k] - want_nu[k]) <= 1e-3 * want_nu[k]))
            # each step's update is at most about lr (AdamW's normalised
            # step) and agrees to 2e-3 where the moments do; the new
            # parameter is rounded once a step on each side
            bound = 2e-3 * tc.learning_rate * steps + 2.5 * steps * eps * np.abs(p0)
            err = np.abs(got_d - want_d) / bound
            worst = max(worst, float(err[same].max()) if same.any() else 0.0)
            checked += int(same.sum())
            total += p0.size
        print(f'{name}: parameter changes after {steps} steps: worst error / tolerance '
              f'{worst:.3f} over {checked} of {total} elements')
        assert worst <= 1.0
        assert checked >= 0.95 * total, f'{name}: only {checked} of {total} changes checked'
    rows = list(csv.DictReader(open(tmp_path / 'port' / 'training_metrics.csv')))
    assert [int(r['epoch']) for r in rows] == [0, 1]


# -- the port alone ------------------------------------------------------------

def _tiny_state(tc, seed=0):
    return create_train_state(tiny_test_config(), tc, seed=seed, device='cpu')


def _snapshot(state):
    """Params, every optimizer's state dict and the step, as CPU copies;
    the set decoder's where the state has one."""
    out = {'step': state.step}
    for name, m in (('enc', state.encoder), ('dec', state.decoder), ('set', state.set_decoder)):
        if m is not None:
            out[name] = {k: v.clone() for k, v in m.state_dict().items()}
    for name in ('enc_opt', 'dec_opt', 'set_opt'):
        if getattr(state, name) is not None:
            out[name] = _clone(getattr(state, name).state_dict())
    return out


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _assert_same(a, b, where='state'):
    """Nested dicts, lists and tensors equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f'{where}[{i}]')
    else:
        assert a == b, (where, a, b)


def test_epoch_runner_is_the_per_step_path():
    """make_epoch_runner over a device-resident dataset (index_select) and
    the step over host-gathered batches: the same parameters, moments and
    metric sums, bit for bit."""
    tc = TrainConfig(**_LOOP)
    luts = build_luts(default_tokenizer(max_len=16), 'cpu')
    ds = synthetic_dataset(n=48, **SYNTH)
    idx_mat = np.random.default_rng(0).integers(0, len(ds), (3, 16))
    dyn = default_dyn(tc)
    a = _tiny_state(tc)
    a, sums = make_epoch_runner(tc, luts)(a, _to_device(ds.batch(np.arange(len(ds))), 'cpu'),
                                          idx_mat, 7, dyn)
    b = _tiny_state(tc)
    step = make_train_step(tc, luts)
    want = {}
    for idx in idx_mat:
        b, m = step(b, _to_device(ds.batch(idx), 'cpu'), 7, dyn)
        want = {k: want[k] + v if k in want else v.clone() for k, v in m.items()}
    _assert_same(sums, want, 'sums')
    _assert_same(_snapshot(a), _snapshot(b))


def test_save_then_load_is_bit_equal(tmp_path):
    """A state mid-accumulation (k=3, one mini-step in) at the defaults
    (with the set decoder) with its controllers and mastery arrays: save,
    load into a fresh state, and every parameter, moment, accumulator,
    count and controller comes back equal."""
    from superconductor_vae_tpu_torch.training import schedulers
    tc = TrainConfig(**dict(_LOOP, accumulation_steps=3, **_DEFAULTS))
    luts = build_luts(default_tokenizer(max_len=16), 'cpu')
    ds = synthetic_dataset(n=48, **SYNTH)
    state = _tiny_state(tc)
    step = make_train_step(tc, luts)
    for i in range(4):
        state, _ = step(state, _to_device(ds.batch(np.arange(i * 8, i * 8 + 8)), 'cpu'), 1,
                        default_dyn(tc))
    assert state.enc_opt.mini_step == state.set_opt.mini_step == 1 and state.step == 4
    drop = schedulers.DropDetector(tc)
    for e, x in enumerate((0.3, 0.5, 0.2)):
        drop.check(e, x)
    skip = schedulers.LossSkipScheduler(tc)
    skip.multipliers(1, {'magpie_loss': 0.01, 'stop_loss': 0.5})
    controllers = {'drop': drop.state_dict(), 'skip': skip.state_dict(), 'best_exact': 0.25,
                   'last_metrics': {'total': 1.0 / 3.0, 'exact_match': 0.1}}
    mastery = {'mastery': torch.linspace(0, 1, 48, dtype=torch.float64),
               'seen': torch.arange(48) % 2 == 0, 'peak': torch.ones(48, dtype=torch.float64)}
    path = save_checkpoint(tmp_path / 'ckpt', state, tiny_test_config(), tc, epoch=4,
                           metrics={'total': 1.5}, controllers=controllers,
                           extra_arrays={'mastery': mastery})
    assert [p.name for p in path.parent.iterdir()] == ['epoch_00004']   # no temporaries
    restored, meta = load_checkpoint(path)
    assert meta['epoch'] == 4 and meta['controllers'] == json.loads(json.dumps(controllers))
    assert set(meta) >= {'epoch', 'metrics', 'model_config', 'manifest', 'controllers',
                         'data_norm'}
    fresh = _tiny_state(tc, seed=5)
    fresh.encoder.load_state_dict(restored['enc_params'])
    fresh.decoder.load_state_dict(restored['dec_params'])
    fresh.set_decoder.load_state_dict(restored['set_params'])
    fresh.step = restored['step']
    for name in ('enc_opt', 'dec_opt', 'set_opt'):
        getattr(fresh, name).load_state_dict(restored[name])
    _assert_same(_snapshot(fresh), _snapshot(state))
    assert 'set' in _snapshot(fresh) and 'set_opt' in _snapshot(fresh)
    for name in ('enc_opt', 'dec_opt', 'set_opt'):
        _assert_same(getattr(fresh, name).acc_grads, getattr(state, name).acc_grads, name)
        assert getattr(fresh, name).mini_step == 1
    _assert_same(restored['mastery'], mastery, 'mastery')
    d2 = schedulers.DropDetector(tc)
    d2.load_state_dict(meta['controllers']['drop'])
    assert d2.state_dict() == drop.state_dict()
    # the next mini-step from the loaded state is the original's
    nxt = _to_device(ds.batch(np.arange(40, 48)), 'cpu')
    _assert_same(_snapshot(step(fresh, nxt, 1, default_dyn(tc))[0]),
                 _snapshot(step(state, nxt, 1, default_dyn(tc))[0]))
    # a save under a tag replaces the older one whole
    for epoch in (4, 5):
        state.step = epoch
        save_checkpoint(tmp_path / 'ckpt', state, tiny_test_config(), tc, epoch=epoch, tag='best')
    restored, meta = load_checkpoint(tmp_path / 'ckpt' / 'best')
    assert meta['epoch'] == restored['step'] == 5
    assert sorted(p.name for p in (tmp_path / 'ckpt').iterdir()) == ['best', 'epoch_00004']


def _write(path, epoch, payload=True):
    path.mkdir(parents=True)
    (path / 'meta.json').write_text(json.dumps({'epoch': epoch}))
    if payload:
        (path / 'state.pt').write_bytes(b'x')


def test_latest_checkpoint_rules(tmp_path):
    root = tmp_path / 'checkpoints'
    assert latest_checkpoint(root) is None
    _write(root / 'epoch_00003', 3)
    _write(root / 'best', 3)
    assert latest_checkpoint(root).name == 'epoch_00003'       # a tie: epoch_* wins
    _write(root / '.epoch_00006.tmp', 6)                       # a save cut off
    _write(root / '.interrupt.old', 6)                         # a replaced save
    _write(root / 'epoch_00005', 5, payload=False)             # without its payload
    assert latest_checkpoint(root).name == 'epoch_00003'
    _write(root / 'interrupt', 4)
    assert latest_checkpoint(root).name == 'interrupt'         # the highest epoch wins
    (root / 'epoch_00005' / 'state.pt').write_bytes(b'x')
    assert latest_checkpoint(root).name == 'epoch_00005'


def _resume_config(**kw):
    """Dropout on (tiny_test_config's 0.1), k=2 accumulation over 3 batches
    an epoch (so a cycle spans the epoch's end and the save), an eval and
    a checkpoint every epoch, and RL activated at epoch 1 by its plateau
    rule, every second epoch from there (epochs 1 and 3), its rollouts at
    the model's max_len; two losses that the skip scheduler takes as
    converged at once, so that epoch 2 (after the resume) skips them; and
    the length curriculum, whose weights make the sampler's stream after
    an eval differ from the base weights' (the resume must re-apply them)."""
    return TrainConfig(**dict(
        _LOOP, num_epochs=4, eval_interval=1, eval_max_batches=2, checkpoint_interval=1,
        accumulation_steps=2, rl_weight=0.0, rl_reactivation_min_exact=0.0,
        rl_reactivation_window=2, rl_reactivation_force_exact=1.0, rl_min_ar_exact=0.0,
        rl_epoch_interval=2, rl=RLConfig(max_len=16),
        loss_skip_schedule=(('magpie_loss', 1e9, 1e9), ('stop_loss', 1e9, 1e9)),
        loss_skip_frequency=3, curriculum_ar_enabled=True, **dict(_DEFAULTS, **kw)))


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    ds = synthetic_dataset(n=48, **SYNTH)
    cfg = tiny_test_config()
    assert cfg.dropout > 0
    whole = train(model_config=cfg, train_config=_resume_config(), dataset=ds,
                  output_dir=tmp_path / 'whole', log_fn=_quiet, device='cpu')
    def interrupt_at_epoch_1(msg):
        if msg.startswith('epoch 1:'):
            signal.raise_signal(signal.SIGINT)      # the loop saves 'interrupt' and stops
    handler = signal.getsignal(signal.SIGINT)
    first = train(model_config=cfg, train_config=_resume_config(), dataset=ds,
                  output_dir=tmp_path / 'cut', log_fn=interrupt_at_epoch_1, device='cpu')
    assert signal.getsignal(signal.SIGINT) is handler
    assert len(first['history']) == 2
    assert (tmp_path / 'cut' / 'checkpoints' / 'interrupt' / 'state.pt').exists()
    logs = []
    rest = train(model_config=cfg, train_config=_resume_config(resume='auto'), dataset=ds,
                 output_dir=tmp_path / 'cut', log_fn=logs.append, device='cpu')
    assert any('[resume]' in m and 'epoch 2' in m for m in logs), logs
    assert [r['epoch'] for r in rest['history']] == [2, 3]
    hist = whole['history']
    assert [r['rl_weight'] > 0 for r in hist] == [False, True, False, True]
    assert hist[1]['mean_reward'] != 0.0
    timing = ('epoch_time_s', 'samples_per_s')
    for g, w in zip(first['history'] + rest['history'], hist):
        assert {k: v for k, v in g.items() if k not in timing} == {
            k: v for k, v in w.items() if k not in timing}
    assert 'set' in _snapshot(whole['state'])
    _assert_same(_snapshot(rest['state']), _snapshot(whole['state']))
    _assert_same(rest['state'].enc_opt.acc_grads, whole['state'].enc_opt.acc_grads)
    _assert_same(rest['state'].set_opt.acc_grads, whole['state'].set_opt.acc_grads)
    rows = list(csv.DictReader(open(tmp_path / 'cut' / 'training_metrics.csv')))
    assert [int(r['epoch']) for r in rows] == [0, 1, 2, 3]       # the resume appended


_ONE_EPOCH = dict(_LOOP, num_epochs=1, checkpoint_interval=1, eval_max_batches=1)


@pytest.fixture(scope='module')
def one_epoch_run(tmp_path_factory):
    """The output directory of a 1-epoch train() call with a checkpoint,
    for the tests that resume from it (each on its own copy)."""
    out = tmp_path_factory.mktemp('one_epoch')
    train(model_config=tiny_test_config(), train_config=TrainConfig(**_ONE_EPOCH),
          dataset=synthetic_dataset(n=32, **SYNTH), output_dir=out, log_fn=_quiet,
          device='cpu')
    return out


def test_params_only_bf16_payload_resumes_with_fresh_optimizers(tmp_path, one_epoch_run):
    """A payload with bf16 params and no optimizer state (a params-only
    snapshot): the resume upcasts the params to float32 masters and starts
    fresh optimizers."""
    import shutil
    ds = synthetic_dataset(n=32, **SYNTH)
    tc = _ONE_EPOCH
    shutil.copytree(one_epoch_run, tmp_path, dirs_exist_ok=True)
    path = latest_checkpoint(tmp_path / 'checkpoints')
    restored, _ = load_checkpoint(path)
    snapshot = {k: {n: v.to(torch.bfloat16) for n, v in restored[k].items()}
                for k in ('enc_params', 'dec_params')}
    torch.save(dict(snapshot, step=restored['step']), path / 'state.pt')
    logs = []
    out = train(model_config=tiny_test_config(),
                train_config=TrainConfig(**dict(tc, num_epochs=2, resume='auto')),
                dataset=ds, output_dir=tmp_path, log_fn=logs.append, device='cpu')
    assert any('opt=False' in m for m in logs), logs
    assert [r['epoch'] for r in out['history']] == [1]
    assert all(p.dtype == torch.float32 for p in out['encoder'].parameters())
    steps = {int(s['step']) for s in out['state'].enc_opt.state_dict()['state'].values()}
    assert steps == {2} and out['state'].step == 4       # 2 fresh updates after step 2


def test_drop_rollback_restores_the_best_checkpoint(tmp_path, monkeypatch, one_epoch_run):
    """When the drop detector fires, the loop loads the 'best' checkpoint's
    params into the models and halves the learning rate."""
    import shutil
    ds = synthetic_dataset(n=32, **SYNTH)
    tc = _ONE_EPOCH
    shutil.copytree(one_epoch_run, tmp_path, dirs_exist_ok=True)
    root = tmp_path / 'checkpoints'
    shutil.copytree(root / 'epoch_00000', root / 'best')
    best, _ = load_checkpoint(root / 'best')

    class Drops(loop_mod.DropDetector):
        def check(self, epoch, exact):
            fired = epoch == 1
            if fired:
                self.lr_scale *= 0.5
            return fired
    monkeypatch.setattr(loop_mod, 'DropDetector', Drops)
    logs = []
    out = train(model_config=tiny_test_config(), train_config=TrainConfig(**dict(
        tc, num_epochs=3, seed=1)), dataset=ds, output_dir=tmp_path, log_fn=logs.append,
        device='cpu')
    assert any(m.startswith('[rollback] epoch 1') and 'restored best' in m for m in logs)
    lrs = [r['lr'] for r in out['history']]
    assert lrs[2] == 0.5 * loop_mod.cosine_lr(2, TrainConfig(**dict(tc, num_epochs=3)))
    saved, _ = load_checkpoint(root / 'epoch_00001')        # saved after the rollback
    for name, v in best['enc_params'].items():
        assert torch.equal(saved['enc_params'][name], v), name


@pytest.mark.parametrize('option,slice_name', [
    (dict(phase2_enabled=True), 'A.14'), (dict(debug_numerics=True), 'A.16')])
def test_unported_options_raise(tmp_path, option, slice_name):
    tc = TrainConfig(**dict(_LOOP, **option))
    with pytest.raises(NotImplementedError, match=slice_name):
        train(model_config=tiny_test_config(), train_config=tc, output_dir=tmp_path,
              limit=16, device='cpu')


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train(model_config=tiny_test_config(), train_config=TrainConfig(**_LOOP), limit=16)


def test_cli_runs_on_the_cpu(tmp_path):
    """The CLI at TrainConfig()'s defaults (the set decoder and the round
    trip on), with no --set, and with soft tokens on through --set."""
    out = cli.main(['--cpu', '--synthetic', '--tiny', '--epochs', '1', '--limit', '32',
                    '--batch-size', '16', '--output', str(tmp_path)])
    assert len(out['history']) == 1 and np.isfinite(out['history'][0]['total'])
    assert (tmp_path / 'training_metrics.csv').exists()
    assert next(out['encoder'].parameters()).device.type == 'cpu'
    assert out['state'].set_decoder is not None
    soft = cli.main(['--cpu', '--synthetic', '--tiny', '--epochs', '1', '--limit', '32',
                     '--batch-size', '16', '--output', str(tmp_path / 'soft'), '--set',
                     'soft_token_enabled=true', '--set', 'soft_token_start_ratio=0.3'])
    assert len(soft['history']) == 1 and np.isfinite(soft['history'][0]['total'])
    assert soft['history'][0]['total'] != out['history'][0]['total']
    with pytest.raises(SystemExit):
        cli.main(['--set', 'no_such_field=1'])


def test_train_resilient_relaunches_with_resume(tmp_path, monkeypatch, capsys):
    """The crash-restart wrapper: a child that exits 1 on its first launch
    is relaunched with ``--resume auto`` and then finishes; the wrapper
    returns 0 (cooldown 0, the poll shortened)."""
    import sys
    from superconductor_vae_tpu_torch.scripts import train_resilient
    child = tmp_path / 'child.py'
    log = tmp_path / 'argv.log'
    child.write_text(
        'import sys\n'
        f'open({str(log)!r}, "a").write(" ".join(sys.argv[1:]) + "\\n")\n'
        'sys.exit(0 if "--resume" in sys.argv else 1)\n')
    monkeypatch.setattr(train_resilient, 'POLL_S', 0.05)
    rc = train_resilient.main(['--cooldown', '0', '--stall-timeout', '60', '--',
                               '--epochs', '3', '--output', str(tmp_path / 'run')],
                              train_cmd=[sys.executable, str(child)])
    assert rc == 0
    assert log.read_text().splitlines() == [
        f'--epochs 3 --output {tmp_path / "run"}',
        f'--epochs 3 --output {tmp_path / "run"} --resume auto']
    out = capsys.readouterr().out
    assert 'exited rc=1; relaunching' in out and 'finished cleanly' in out
