"""The port resumes training from the JAX package's Orbax checkpoints, as the
JAX package does (checkpoint/from_jax.py ``train_payload_from_jax``,
checkpoint/io.py ``load_train_checkpoint`` and ``latest_checkpoint``, the
loop's resume, the CLIs).

At tiny width, dropout 0 in every model (the flax set decoder's own
dropout too), with the set decoder, the round trip and the physics-Z
projection on (physics-Z forced active from the first epoch, so that all
four groups train):
- JAX's ``train()`` runs one epoch of 3 steps and is stopped by SIGINT,
  which saves an 'interrupt' checkpoint (no eval ran, so JAX's resume and
  the port's, which re-applies the mastery weights, draw the same
  batches); JAX resumes it for one more epoch and the port's ``train()``
  does the same from the JAX directory: the epoch's history row within
  1e-4 relative, the true-AR exact match equal but for near-tie rows, and
  the four groups' AdamW moments, step counts, learning rates and
  parameter changes as tests/test_torch_port_loop.py holds them; with
  ``accumulation_steps`` 2 the save falls mid-accumulation, and the
  accumulators and the mini-step must match too;
- the same from a params-only bf16 snapshot of that checkpoint written by
  the JAX package's scripts/snapshot_params.py: fresh optimizers, float32
  masters equal to the bf16 leaves widened, step and epoch carried; its
  next epoch's parameter changes within 1e-2 of lr an update, since from
  fresh moments AdamW's normalised steps amplify float32 noise;
- ``opt_state_from_jax`` against optax's own leaf order (every leaf of a
  state filled with a value of its own), and its refusal of a leaf count
  that is not the chain's;
- ``--resume auto`` over JAX and port ``epoch_*`` directories picks the
  highest epoch in either format;
- the migrate CLI's ``deepen`` and ``expand-vocab`` and ``snapshot_params``
  on the JAX checkpoint give what the JAX CLIs give, both loaded into the
  port;
- run5's corpus (jarvis_merged_v2.csv.gz) through ``load_dataset`` with the
  quantile transform and order augmentation K=1 on its first 256 rows, bit
  for bit against JAX's.

JAX's ``train()`` builds its initial state and its jitted step anew in
every call; here both are built once a configuration and handed to every
call (the step is a pure function of its configuration), which keeps the
file's compile time to one step a configuration.
"""

import dataclasses
import json
import runpy
import shutil
import signal
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import superconductor_vae_tpu.training.train_loop as jax_loop_mod
import superconductor_vae_tpu.training.train_step as jts
import superconductor_vae_tpu_torch.training.train_loop as loop_mod
import superconductor_vae_tpu_torch.training.train_step as port_step_mod
from superconductor_vae_tpu.data import pipeline as jax_pipeline
from superconductor_vae_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.checkpoint import (
    latest_checkpoint, load_train_checkpoint, opt_state_from_jax, save_checkpoint)
from superconductor_vae_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from superconductor_vae_tpu_torch.checkpoint.ocdbt import read_snapshot
from superconductor_vae_tpu_torch.data import pipeline, synthetic_dataset
from superconductor_vae_tpu_torch.models import FormulaDecoder, config_from_meta, tiny_test_config
from superconductor_vae_tpu_torch.models.set_decoder import SetDecoderLayer
from superconductor_vae_tpu_torch.scripts import migrate_checkpoint, snapshot_params
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import TrainConfig, create_train_state, train
from superconductor_vae_tpu_torch.training.train_step import MultiSteps
from superconductor_vae_tpu_torch.utils.npz import as_f32
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_dataset import assert_same_dataset
from test_torch_port_loop import TIE, _Recorder
from test_torch_port_train_step import _adam_states, _leaves, _tree_close
from torch_port_common import jax_config, param_trees

ROOT = Path(__file__).resolve().parents[1]
CSV_V2 = ROOT / 'data/processed/jarvis_merged_v2.csv.gz'
JAX_SCRIPTS = ROOT / 'scripts'
# physics-Z slices the latent into 512-wide blocks
CFG = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0)
SYNTH = dict(n=48, max_len=16, magpie_dim=16)       # 3 batches of 16 an epoch
_RESUME = dict(batch_size=16, max_formula_len=16, learning_rate=1e-3,
               hungarian_d_model=32, hungarian_num_layers=2, hungarian_dim_feedforward=64,
               eval_interval=100, checkpoint_interval=100, device_resident_data=False,
               physics_z_reactivation_force_exact=0.0)
# JAX's groups, and the port's modules of the same parameters
GROUPS = {'enc': 'encoder', 'dec': 'decoder', 'set': 'set_decoder', 'pz': 'pz_proj'}


def _quiet(*a, **k):
    pass


class _JaxTrain:
    """JAX's ``train()`` with one initial state and one jitted step a
    configuration, the flax set decoder's dropout off, and, for a run asked
    to stop, a SIGINT raised at its first step (the loop saves 'interrupt'
    at the end of the epoch and stops)."""

    def __init__(self, mp):
        self.states, self.steps, self.stop = {}, {}, False
        real_create, real_make, real_set = (jax_loop_mod.create_train_state,
                                            jax_loop_mod.make_train_step,
                                            jts.make_set_decoder)

        def create(mcfg, tcfg, rng, dtype=jax.numpy.float32):
            if 'base' not in self.states:      # host copies: the step donates its inputs
                encoder, decoder, state, _, _ = real_create(mcfg, tcfg, rng, dtype)
                self.states['base'] = encoder, decoder, jax.tree.map(np.asarray, state)
            encoder, decoder, state = self.states['base']
            tx_enc, tx_dec = jts.make_optimizer(tcfg), jts.make_optimizer(tcfg)
            return encoder, decoder, state.replace(
                enc_opt=tx_enc.init(state.enc_params), dec_opt=tx_dec.init(state.dec_params),
                set_opt=tx_dec.init(state.set_params), pz_opt=tx_enc.init(state.pz_params)), \
                tx_enc, tx_dec

        def make(*args, rl_enabled=False, **kwargs):
            key = (rl_enabled, args[2].accumulation_steps)
            if key not in self.steps:
                self.steps[key] = real_make(*args, rl_enabled=rl_enabled, **kwargs)
            step = self.steps[key]

            def run(*a, **k):
                out = step(*a, **k)
                if self.stop:
                    self.stop = False
                    signal.raise_signal(signal.SIGINT)
                return out
            return run

        mp.setattr(jax_loop_mod, 'create_train_state', create)
        mp.setattr(jax_loop_mod, 'make_train_step', make)
        mp.setattr(jts, 'make_set_decoder',
                   lambda *a, **k: real_set(*a, **k).clone(dropout=0.0))

    def __call__(self, out_dir, stop=False, **kw):
        self.stop = stop
        return jax_loop_mod.train(model_config=jax_config(CFG),
                                  train_config=JaxTrainConfig(**(_RESUME | kw)),
                                  dataset=jax_synthetic(**SYNTH), output_dir=out_dir,
                                  use_mesh=False, log_fn=_quiet)


@pytest.fixture(scope='module')
def jax_train():
    mp = pytest.MonkeyPatch()
    real_set = port_step_mod.make_set_decoder

    def port_set_decoder(*args, **kwargs):       # without dropout, as the flax one here
        dec = real_set(*args, **kwargs)
        for layer in dec.modules():
            if isinstance(layer, SetDecoderLayer):
                layer.dropout = 0.0
        return dec
    mp.setattr(port_step_mod, 'make_set_decoder', port_set_decoder)
    yield _JaxTrain(mp)
    mp.undo()


@pytest.fixture(scope='module')
def interrupted(jax_train, tmp_path_factory):
    """``interrupted(k)``: a JAX run at ``accumulation_steps`` k stopped
    after its first epoch (3 steps), made once: (its 'interrupt'
    checkpoint, its state)."""
    runs = {}

    def run(k):
        if k not in runs:
            root = tmp_path_factory.mktemp(f'jax_k{k}')
            out = jax_train(root, stop=True, num_epochs=2, accumulation_steps=k)
            assert len(out['history']) == 1
            runs[k] = root / 'checkpoints' / 'interrupt', out['state']
        return runs[k]
    return run


def _resume_both(jax_train, ckpt, tmp_path, k, monkeypatch):
    """JAX's and the port's ``train()`` resumed from ``ckpt`` for epoch 1,
    each eval recorded; returns (JAX's result, the port's, their evals,
    the port's log)."""
    jax_rec = _Recorder(jax_loop_mod.evaluate_autoregressive)
    monkeypatch.setattr(jax_loop_mod, 'evaluate_autoregressive', jax_rec)
    want = jax_train(tmp_path / 'jax', num_epochs=2, accumulation_steps=k, resume=str(ckpt))
    rec = _Recorder(loop_mod.evaluate_autoregressive)
    monkeypatch.setattr(loop_mod, 'evaluate_autoregressive', rec)
    log = []
    got = train(model_config=CFG, train_config=TrainConfig(
                    **_RESUME, num_epochs=2, accumulation_steps=k, resume=str(ckpt)),
                dataset=synthetic_dataset(**SYNTH), output_dir=tmp_path / 'port',
                log_fn=log.append, device='cpu')
    return want, got, (jax_rec.outputs, rec.outputs), log


def _jax_adam(opt_state, k):
    return _adam_states(opt_state.inner_opt_state if k > 1 else opt_state)


def _port_group(state, name):
    module = getattr(state, GROUPS[name])
    return module, getattr(state, f'{name}_opt')


def _assert_resumed_epoch_matches(want, got, evals, start, k, step_tol=2e-3):
    """The resumed epoch of JAX (``want``) and of the port (``got``) from
    the JAX state ``start``, at tests/test_torch_port_loop.py's tolerances:
    the parameter changes within ``step_tol`` of lr an update (plus 2.5
    float32 ulp) wherever the moments agree to 1e-3, at least 95% of the
    elements."""
    assert [r['epoch'] for r in got['history']] == [r['epoch'] for r in want['history']] == [1]
    g, w = got['history'][0], want['history'][0]
    for key in ('total', 'formula_loss', 'tc_loss', 'exact_match', 'token_accuracy'):
        np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-7, err_msg=key)
    for key in ('lr', 'rl_weight', 'physz_weight'):
        assert g[key] == w[key], key
    assert g['physz_weight'] > 0 and g['rl_weight'] == 0
    (je,), (e,) = evals
    differ = e['per_sample_ar_exact'] != je['per_sample_ar_exact']
    assert not (differ & ~(e['per_sample_margin'] < TIE)).any()
    if not differ.any():
        assert g['true_ar_exact'] == w['true_ar_exact']

    js, ps = want['state'], got['state']
    assert ps.step == int(js.step) == int(start.step) + 3
    eps = np.finfo(np.float32).eps
    for name in GROUPS:
        module, opt = _port_group(ps, name)
        jopt = getattr(js, f'{name}_opt')
        adam, adam0 = _jax_adam(jopt, k), _jax_adam(getattr(start, f'{name}_opt'), k)
        updates = int(adam.count) - int(adam0.count)
        assert updates == (3 if k == 1 else 2), name
        want_mu, want_nu = _leaves(adam.mu), _leaves(adam.nu)
        params = dict(module.named_parameters())
        got_mu = {n: opt.state[p]['exp_avg'].numpy() for n, p in params.items()}
        got_nu = {n: opt.state[p]['exp_avg_sq'].numpy() for n, p in params.items()}
        _tree_close(got_mu, want_mu, f'{name} mu')
        _tree_close(got_nu, want_nu, f'{name} nu')
        assert {float(opt.state[p]['step']) for p in params.values()} == {int(adam.count)}
        inner = jopt.inner_opt_state if k > 1 else jopt
        np.testing.assert_allclose(opt.param_groups[0]['lr'],
                                   float(inner[1].hyperparams['learning_rate']), rtol=1e-7)
        if k > 1:
            assert isinstance(opt, MultiSteps) and opt.mini_step == int(jopt.mini_step) == 0
        # the parameter changes over the epoch, where the moments agree
        p0 = _leaves(getattr(start, f'{name}_params'))
        end = _leaves(getattr(js, f'{name}_params'))
        checked = total = 0
        for n, before in p0.items():
            got_d = params[n].detach().numpy() - before
            want_d = end[n] - before
            same = ((np.abs(got_mu[n] - want_mu[n]) <= 1e-3 * np.abs(want_mu[n]))
                    & (np.abs(got_nu[n] - want_nu[n]) <= 1e-3 * want_nu[n]))
            bound = (step_tol * _RESUME['learning_rate'] * updates
                     + 2.5 * updates * eps * np.abs(before))
            assert (np.abs(got_d - want_d)[same] <= bound[same]).all(), (name, n)
            checked += int(same.sum())
            total += before.size
        assert checked >= 0.95 * total, f'{name}: only {checked} of {total} changes checked'


@pytest.mark.parametrize('k', [1, 2])
def test_resume_of_a_jax_checkpoint_matches_jax(interrupted, jax_train, tmp_path,
                                                monkeypatch, k):
    ckpt, start = interrupted(k)
    want, got, evals, log = _resume_both(jax_train, ckpt, tmp_path, k, monkeypatch)
    line = next(x for x in log if x.startswith('[resume] ') and ' -> epoch ' in x)
    assert ('format orbax; optimizer moments: enc_opt, dec_opt, set_opt, pz_opt; step 3'
            in line), line
    if k > 1:
        # the save fell mid-accumulation: the converted accumulators are JAX's
        payload, _, _ = load_train_checkpoint(ckpt, k)
        for name in GROUPS:
            jopt = getattr(start, f'{name}_opt')
            assert payload[f'{name}_opt']['mini_step'] == int(jopt.mini_step) == 1
            names = [n for n, _ in _port_group(got['state'], name)[0].named_parameters()]
            acc = _leaves(jopt.acc_grads)
            assert any(np.abs(a).max() > 0 for a in acc.values())
            for n, a in zip(names, payload[f'{name}_opt']['acc_grads']):
                assert np.array_equal(a.numpy(), acc[n]), (name, n)
    _assert_resumed_epoch_matches(want, got, evals, start, k)


# -- a params-only bf16 snapshot of the JAX package ---------------------------------

@pytest.fixture(scope='module')
def jax_snapshot(interrupted, tmp_path_factory):
    """The JAX package's scripts/snapshot_params.py of the k=1 checkpoint."""
    ckpt, start = interrupted(1)
    out = tmp_path_factory.mktemp('snap') / 'snap'
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, 'argv', ['snapshot_params.py', '--checkpoint', str(ckpt),
                                 '--out', str(out)])
        runpy.run_path(str(JAX_SCRIPTS / 'snapshot_params.py'), run_name='__main__')
    return out, start


def test_resume_of_a_jax_snapshot(jax_snapshot, jax_train, tmp_path, monkeypatch):
    snap, start = jax_snapshot
    trees = read_snapshot(snap / 'state')
    assert trees['enc_params']['params']['magpie_encoder']['Dense_0']['kernel'].dtype.kind == 'V'
    # before any update: float32 masters equal to the bf16 leaves widened,
    # fresh optimizers, the step and the epoch carried
    log = []
    out = train(model_config=CFG, train_config=TrainConfig(**_RESUME, num_epochs=1,
                                                           resume=str(snap)),
                dataset=synthetic_dataset(**SYNTH), output_dir=tmp_path / 'before',
                log_fn=log.append, device='cpu')
    assert out['history'] == [] and out['state'].step == int(start.step) == 3
    line = next(x for x in log if x.startswith('[resume] ') and ' -> epoch ' in x)
    assert ('-> epoch 1 (opt=False ctl=True; format orbax; optimizer moments: none, params '
            'only; step 3)' in line), line
    for name in GROUPS:
        module, opt = _port_group(out['state'], name)
        want = state_dict_from_flax(trees[f'{name}_params'])
        for n, p in module.named_parameters():
            assert p.dtype == torch.float32 and torch.equal(p.detach(), want[n]), (name, n)
        assert not opt.state, name
    # the next epoch, against JAX's resume of the same snapshot, which
    # starts from the widened leaves with fresh optimizer states
    want, got, evals, _ = _resume_both(jax_train, snap, tmp_path, 1, monkeypatch)
    tx = jts.make_optimizer(JaxTrainConfig(**_RESUME))
    masters = {g: jax.tree.map(as_f32, trees[f'{g}_params']) for g in GROUPS}
    snap_start = SimpleNamespace(step=start.step,
                                 **{f'{g}_params': masters[g] for g in GROUPS},
                                 **{f'{g}_opt': tx.init(masters[g]) for g in GROUPS})
    # from fresh moments AdamW's normalised steps amplify float32 noise
    # where successive gradients cancel (m-hat near 0 against sqrt(v-hat)):
    # up to 4x the full-state resume's bound of 2e-3 lr an update here, so
    # the changes are held to 1e-2 of lr an update
    _assert_resumed_epoch_matches(want, got, evals, snap_start, 1, step_tol=1e-2)


# -- optax's leaf order ------------------------------------------------------------------

@pytest.mark.parametrize('k', [1, 2])
def test_opt_state_leaf_order_matches_optax(k):
    """Every leaf of an optax state of the JAX chain but the hyperparameters
    gets a value of its own; the port's optimizer state holds each where
    the JAX state has it."""
    enc, _ = param_trees(tiny_test_config(), seed=0)
    tx = jts.make_optimizer(JaxTrainConfig(accumulation_steps=k))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tx.init(enc))
    filled = [np.asarray(x) if 'hyperparams' in jax.tree_util.keystr(path)
              else np.full(np.shape(x), i + 1, np.asarray(x).dtype)
              for i, (path, x) in enumerate(leaves)]
    jstate = jax.tree.unflatten(treedef, filled)
    module = create_train_state(tiny_test_config(), TrainConfig(), device='cpu').encoder
    names = [n for n, _ in module.named_parameters()]
    sd = opt_state_from_jax(filled, enc, names, k)
    inner = sd['inner'] if k > 1 else sd
    adam = _jax_adam(jstate, k)
    mu, nu = _leaves(adam.mu), _leaves(adam.nu)
    for i, n in enumerate(names):
        s = inner['state'][i]
        assert torch.equal(s['exp_avg'], torch.from_numpy(mu[n])), n
        assert torch.equal(s['exp_avg_sq'], torch.from_numpy(nu[n])), n
        assert float(s['step']) == int(adam.count)
    hyper = (jstate.inner_opt_state if k > 1 else jstate)[1].hyperparams
    group = inner['param_groups'][0]
    assert group['lr'] == float(hyper['learning_rate'])
    assert group['weight_decay'] == float(hyper['weight_decay'])
    assert group['betas'] == (float(hyper['b1']), float(hyper['b2']))
    assert group['params'] == list(range(len(names)))
    if k > 1:
        assert sd['mini_step'] == int(jstate.mini_step)
        acc = _leaves(jstate.acc_grads)
        for n, a in zip(names, sd['acc_grads']):
            assert torch.equal(a, torch.from_numpy(acc[n])), n
    # the state loads into the port's optimizer of those parameters
    opt = port_step_mod.make_optimizer(TrainConfig(accumulation_steps=k), module.parameters())
    opt.load_state_dict(sd)
    with pytest.raises(ValueError, match=f'{len(filled) - 1} leaves.*has {len(filled)}'):
        opt_state_from_jax(filled[:-1], enc, names, k)
    with pytest.raises(ValueError, match='leaves'):
        opt_state_from_jax(filled, enc, names, 3 - k)


# -- --resume auto over both formats -------------------------------------------------

def _jax_copy_at_epoch(src, dst, epoch):
    shutil.copytree(src, dst)
    meta = json.loads((dst / 'meta.json').read_text())
    (dst / 'meta.json').write_text(json.dumps(dict(meta, epoch=epoch)))
    return dst


def test_resume_auto_picks_the_highest_epoch_in_either_format(interrupted, tmp_path):
    ckpt, start = interrupted(1)
    root = tmp_path / 'run' / 'checkpoints'
    root.mkdir(parents=True)
    (root / 'epoch_00000').symlink_to(ckpt, target_is_directory=True)    # as run5 is seeded
    assert latest_checkpoint(root) == root / 'epoch_00000'
    tc = TrainConfig(**_RESUME, num_epochs=3)
    state = create_train_state(CFG, tc, device='cpu')
    port = save_checkpoint(root, state, CFG, tc, epoch=2)
    assert latest_checkpoint(root) == port
    _jax_copy_at_epoch(ckpt, root / 'epoch_00005', 5)
    assert latest_checkpoint(root) == root / 'epoch_00005'
    log = []
    out = train(model_config=CFG, train_config=dataclasses.replace(tc, num_epochs=6,
                                                                   resume='auto'),
                dataset=synthetic_dataset(**SYNTH), output_dir=tmp_path / 'run',
                log_fn=log.append, device='cpu')
    line = next(x for x in log if x.startswith('[resume] ') and ' -> epoch ' in x)
    assert 'epoch_00005 -> epoch 6 (opt=True ctl=True; format orbax;' in line, line
    assert out['state'].step == int(start.step)


# -- the CLIs on a JAX checkpoint ----------------------------------------------------

def _jax_cli(name, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [f'{name}.py', *argv])
    runpy.run_path(str(JAX_SCRIPTS / f'{name}.py'), run_name='__main__')


def _params(path):
    payload, meta, _ = load_train_checkpoint(path)
    return {k: {n: v.float() for n, v in payload[k].items()}
            for k in payload if k.endswith('_params')}, payload, meta


@pytest.mark.parametrize('cmd,flags,tag', [
    ('deepen', ['--layers', '1'], 'deepened+1'),
    ('expand-vocab', ['--new-vocab', '4800'], 'vocab-expanded'),
])
def test_migrate_cli_on_a_jax_checkpoint_matches_jax(interrupted, tmp_path, monkeypatch,
                                                     cmd, flags, tag):
    ckpt, _ = interrupted(1)
    _jax_cli('migrate_checkpoint', [cmd, str(ckpt), *flags, '--out', str(tmp_path / 'jax')],
             monkeypatch)
    path = migrate_checkpoint.main([cmd, str(ckpt), *flags, '--out', str(tmp_path / 'port')])
    assert path == (tmp_path / 'port' / tag).resolve()
    got, _, got_meta = _params(path)
    want, _, want_meta = _params(tmp_path / 'jax' / tag)
    # the JAX CLI saves each optimizer state as an empty list
    assert read_snapshot(tmp_path / 'jax' / tag / 'state')['enc_opt'] == []
    assert got_meta['model_config'] == {**want_meta['model_config']}
    assert got_meta['epoch'] == want_meta['epoch'] == 0
    # the JAX CLI drops the physics-Z projection, the port's keeps it
    src, _, _ = _params(ckpt)
    assert torch.equal(got.pop('pz_params')['weight'], src['pz_params']['weight'])
    assert set(got) == set(want) == {'enc_params', 'dec_params', 'set_params'}
    for group in want:
        assert got[group].keys() == want[group].keys(), group
        for n in want[group]:
            assert torch.equal(got[group][n], want[group][n]), (group, n)
    # the migrated decoder loads at the migrated config
    FormulaDecoder(config_from_meta(got_meta['model_config']),
                   device='cpu').load_state_dict(got['dec_params'])


def test_snapshot_cli_on_a_jax_checkpoint_matches_jax(interrupted, tmp_path, monkeypatch,
                                                      capsys):
    ckpt, _ = interrupted(1)
    _jax_cli('snapshot_params', ['--checkpoint', str(ckpt), '--out', str(tmp_path / 'jax')],
             monkeypatch)
    jax_mb = capsys.readouterr().out.strip().rsplit('(', 1)[1]
    note = snapshot_params.main(['--checkpoint', str(ckpt), '--out', str(tmp_path / 'port')])
    port_mb = capsys.readouterr().out.strip().rsplit('(', 1)[1]
    assert note['params_dtype'] == 'bfloat16'
    got, got_payload, _ = _params(tmp_path / 'port')
    want, want_payload, _ = _params(tmp_path / 'jax')
    assert not any(key.endswith('_opt') for key in got_payload)
    assert set(got_payload) == set(want_payload)
    assert got_payload['step'] == want_payload['step'] == 3
    for group in want:
        for n, w in want[group].items():
            assert got_payload[group][n].dtype == torch.bfloat16, (group, n)
            assert torch.equal(got[group][n], w), (group, n)
    for key in ('mastery', 'peak', 'seen'):
        assert torch.equal(got_payload['mastery'][key], want_payload['mastery'][key])
    # the bytes of the same payload (the JAX script counts numpy's)
    assert port_mb == jax_mb and port_mb != '0 MB)', (port_mb, jax_mb)


# -- run5's corpus -------------------------------------------------------------------

def test_v2_corpus_quantile_order_augmented_matches_jax():
    kw = dict(max_len=30, limit=256, skew_transform='quantile', order_augment=1,
              order_augment_seed=0)
    want = jax_pipeline.load_dataset(CSV_V2, cache_dir=None, **kw)
    got = pipeline.load_dataset(CSV_V2, tokenizer=default_tokenizer(max_len=30), **kw)
    assert len(got) > 256 and got.aug_group is not None
    assert_same_dataset(got, want)
    np.testing.assert_array_equal(got.aug_group, want.aug_group)
