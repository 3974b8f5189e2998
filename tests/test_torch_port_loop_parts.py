"""The host loop's parts in the port against the JAX package, on the same
inputs: the auxiliary losses (``ops/aux_losses.py``) and
``multitask_loss`` with SupCon, the controllers of
``training/schedulers.py`` on scripted metric sequences (with
``state_dict`` round trips), the weighted sampler, the sample weights,
order augmentation, canonical ordering, mastery sampling and the
curriculum, manifest drift, the checkpoint auto-migration, the topology
analyzer, the latent cache, and the train step's gradient accumulation.

Tolerances: the host-side parts are the same numpy or Python arithmetic on
both sides, so their results are held equal (index streams, weights,
arrays, controller outputs and states, migrated parameters, topology
metrics).  The losses are float32 on both sides in other summation
orders: values and gradients within 2e-5 relative and 1e-6 absolute, as
tests/test_torch_port_losses.py holds the loss terms.  The latent cache
comes out of a float32 encoder on both sides: within 2e-5 relative, plus
2e-5 of the largest magnitude.  Gradient accumulation (k=2) over 4
mini-steps of 8 synthetic rows against ``make_train_step`` with
``accumulation_steps=2`` (optax ``MultiSteps``), from the same states, at
the tolerances of tests/test_torch_port_train_step.py: metrics 1e-4
relative; the accumulated gradients and the AdamW moments 1e-3 relative
plus 1e-4 of their tree's largest magnitude; the parameter changes by
that file's ``check_moments_and_updates``; the parameters unmoved, bit for
bit, between updates.
"""

import copy
import csv
import dataclasses
import gzip
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.analysis import TopologyAnalyzer as JaxTopology
from superconductor_vae_tpu.checkpoint import check_manifest_drift as jax_drift
from superconductor_vae_tpu.checkpoint.migrate import auto_migrate as jax_migrate
from superconductor_vae_tpu.data import canonical_ordering as j_co
from superconductor_vae_tpu.data import pipeline as j_pipe
from superconductor_vae_tpu.data import sampler as j_sampler
from superconductor_vae_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from superconductor_vae_tpu.generation.latent_analyzer import (
    LatentSpaceAnalyzer as JaxLatentAnalyzer)
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.ops import aux_losses as j_aux
from superconductor_vae_tpu.ops import losses as j_losses
from superconductor_vae_tpu.ops.physics_z_loss import init_magpie_proj as jax_init_proj
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import mastery_sampler as j_mastery
from superconductor_vae_tpu.training import schedulers as j_sched
from superconductor_vae_tpu.training import train_step as jts
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.analysis import TopologyAnalyzer
from superconductor_vae_tpu_torch.checkpoint import auto_migrate, check_manifest_drift
from superconductor_vae_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from superconductor_vae_tpu_torch.data import (
    WeightedEpochSampler, compute_sample_weights, load_dataset,
    resample_order_augmentation, shard_batch_indices, synthetic_dataset)
from superconductor_vae_tpu_torch.data import canonical_ordering as co
from superconductor_vae_tpu_torch.generation.latent_analyzer import LatentSpaceAnalyzer
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.ops import aux_losses, losses
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    MultiSteps, TrainConfig, build_luts, default_dyn, make_train_step, schedulers)
from superconductor_vae_tpu_torch.training import mastery_sampler
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_losses import GRAD_KEYS, TOK, _batch_and_outputs, _torch
from test_torch_port_train_step import (
    MET_TOL, TCFG, _TINY, _adam_states, _leaves, _port_moments, _port_params, _port_state,
    _to_torch, _tree_close, check_moments_and_updates)
from torch_port_common import jax_config, param_trees, port_models

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / 'data/processed/jarvis_merged.csv.gz'
TOL = dict(rtol=2e-5, atol=1e-6)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), **(tol or TOL))


# -- the auxiliary losses -----------------------------------------------------

@pytest.mark.parametrize('labels', ['mixed', 'no_positives', 'one_row'])
def test_supcon_loss_and_gradient_match_jax(labels):
    rng = np.random.default_rng(3)
    b = 1 if labels == 'one_row' else 12
    z = rng.standard_normal((b, 24)).astype(np.float32)
    lab = (np.arange(b) if labels == 'no_positives'
           else rng.integers(0, 3, b)).astype(np.int32)
    want, want_g = jax.value_and_grad(
        lambda x: j_aux.supcon_loss(x, jnp.asarray(lab), 0.1, 0.07))(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    got = aux_losses.supcon_loss(zt, torch.as_tensor(lab).long(), 0.1, 0.07)
    _close(got, want)
    if b > 1:
        got.backward()
        _close(zt.grad, want_g, rtol=2e-5, atol=1e-7)
    if labels == 'no_positives':
        assert float(got.detach()) == 0.0


@pytest.mark.parametrize('huber_delta', [None, 0.5])
def test_consistency_losses_match_jax(huber_delta):
    rng = np.random.default_rng(4)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    o, r, om, rm = f32(16, 1), f32(16), f32(16, 9), f32(16, 9)
    for mag in (True, False):
        kw = dict(tc_weight=2.0, magpie_weight=0.3, huber_delta=huber_delta,
                  normalize_magpie=mag)
        want = j_aux.self_consistency_loss(o, r, om, rm, **kw)
        got = aux_losses.self_consistency_loss(*map(torch.as_tensor, (o, r, om, rm)), **kw)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    want = j_aux.self_consistency_loss(o, r, huber_delta=huber_delta)
    got = aux_losses.self_consistency_loss(torch.as_tensor(o), torch.as_tensor(r),
                                           huber_delta=huber_delta)
    for k in want:
        _close(got[k], want[k])
    for n in (16, 1):
        want = j_aux.bidirectional_consistency_loss(o[:n], r[:n], tc_weight=1.5,
                                                    huber_delta=huber_delta)
        got = aux_losses.bidirectional_consistency_loss(
            torch.as_tensor(o[:n]), torch.as_tensor(r[:n]), tc_weight=1.5,
            huber_delta=huber_delta)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])


def test_multitask_loss_with_supcon_matches_jax():
    """supcon_weight > 0 with the batch's labels: the total and every
    gradient against the JAX loss (whose SupCon term is
    ops/aux_losses.py's), and the total differs from the one without it."""
    batch, enc_out, dec_out = _batch_and_outputs(seed=5)
    batch['label'] = np.array([0, 1, 0, 2, 1, 0, 3, 2], np.int32)
    jcfg = j_losses.LossConfig(supcon_weight=0.3, supcon_temperature=0.1)
    cfg = losses.LossConfig(**dataclasses.asdict(jcfg))
    type_table = TOK.token_type_table

    def jax_total(e, d):
        return j_losses.multitask_loss(jcfg, e, d, batch, jnp.asarray(type_table))
    (want_total, _), grads = jax.jit(jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in enc_out.items()},
        {k: jnp.asarray(v) for k, v in dec_out.items()})
    e, d = _torch(enc_out, GRAD_KEYS), _torch(dec_out, GRAD_KEYS)
    total, _ = losses.multitask_loss(cfg, e, d, _torch(batch), torch.as_tensor(type_table))
    _close(total, want_total)
    total.backward()
    _close(e['z'].grad, grads[0]['z'], rtol=2e-5, atol=1e-7)
    without, _ = losses.multitask_loss(losses.LossConfig(), _torch(enc_out), _torch(dec_out),
                                       _torch(batch), torch.as_tensor(type_table))
    assert abs(float(total.detach()) - float(without)) > 1e-3


# -- the controllers, on scripted metric sequences ----------------------------

def _configs(**kw):
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def test_functional_schedules_match_jax():
    for kw in (dict(), dict(lr_warmup_epochs=5, num_epochs=40, lr_min_factor=0.1),
               dict(tf_locked=False, tf_onset=0.5, curriculum_phase1_end=7)):
        jc, pc = _configs(**kw)
        for epoch in range(0, 60, 3):
            assert schedulers.cosine_lr(epoch, pc) == j_sched.cosine_lr(epoch, jc)
            assert (schedulers.curriculum_weights(epoch, pc)
                    == j_sched.curriculum_weights(epoch, jc))
        for exact in np.linspace(0, 1, 23):
            assert (schedulers.teacher_forcing_ratio(exact, pc)
                    == j_sched.teacher_forcing_ratio(exact, jc))


# tf_exact sequences: a climb to the forced activation, a plateau, dips
# past the regression thresholds and a recovery
_EXACT = [0.1, 0.5, 0.86, 0.86, 0.861, 0.96, 0.97, 0.93, 0.92, 0.90, 0.85, 0.97,
          0.99, 0.6, 0.55, 0.98, 0.98, 0.7, 0.97, 0.99]


def _run_pair(make_jax, make_port, drive, n_split=7):
    """Drives the JAX and port controllers through ``drive(obj, i)`` for
    every step, the port's re-created from its ``state_dict`` (through
    JSON, as a checkpoint's meta carries it) at step ``n_split``; outputs
    and states must be equal at every step."""
    j, p = make_jax(), make_port()
    for i in range(len(_EXACT)):
        if i == n_split:
            saved = json.loads(json.dumps(p.state_dict()))
            p = make_port()
            p.load_state_dict(saved)
        assert drive(p, i) == drive(j, i), i
        assert json.dumps(p.state_dict()) == json.dumps(j.state_dict()), i


@pytest.mark.parametrize('kw', [
    dict(physics_z_reactivation_window=3, physics_z_regression_check_interval=1,
         physics_z_warmup_epochs=4),
    dict(physics_z_reactivation_min_exact=0.5, physics_z_reactivation_window=2,
         physics_z_regression_threshold=0.05, physics_z_weight_floor=0.3),
    dict(use_physics_z=False)])
def test_physz_controller_matches_jax(kw):
    jc, pc = _configs(**kw)
    _run_pair(lambda: j_sched.PhysZController(jc), lambda: schedulers.PhysZController(pc),
              lambda c, i: c.epoch_update(i, _EXACT[i]))


@pytest.mark.parametrize('kw', [dict(), dict(loss_skip_frequency=3),
                                dict(loss_skip_enabled=False)])
def test_loss_skip_scheduler_matches_jax(kw):
    jc, pc = _configs(**kw)
    rng = np.random.default_rng(9)
    names = [n for n, _, _ in jc.loss_skip_schedule]
    seq = [None] + [{n: float(v) for n, v in zip(names, rng.choice([0.005, 0.05, 0.2, 0.45, 0.9],
                                                                    len(names)))}
                    for _ in range(len(_EXACT) - 1)]
    seq[5].pop('hp_loss')                              # a metric the epoch lacks
    _run_pair(lambda: j_sched.LossSkipScheduler(jc), lambda: schedulers.LossSkipScheduler(pc),
              lambda c, i: c.multipliers(i, seq[i]))


@pytest.mark.parametrize('kw', [dict(), dict(max_rollbacks=1, rollback_grace_epochs=2),
                                dict(disable_drop_detection=True)])
def test_drop_detector_matches_jax(kw):
    jc, pc = _configs(**kw)

    def drive(c, i):
        return c.check(i, _EXACT[i]), c.lr_scale
    _run_pair(lambda: j_sched.DropDetector(jc), lambda: schedulers.DropDetector(pc), drive)


def test_rl_and_entropy_controllers_round_trip():
    jc, pc = _configs(rl_weight=0.0, rl_reactivation_min_exact=0.5,
                      rl_reactivation_window=2, rl_min_ar_exact=0.0, rl_epoch_interval=2,
                      entropy_strategy='composite')
    _run_pair(lambda: j_sched.RLController(jc), lambda: schedulers.RLController(pc),
              lambda c, i: (c.epoch_update(i, _EXACT[i], _EXACT[i] - 0.1,
                                           raw_rl_loss=0.3 + 0.01 * i), c.temperature(i)))
    _run_pair(lambda: j_sched.EntropyManager(jc), lambda: schedulers.EntropyManager(pc),
              lambda c, i: c.update(_EXACT[i] * 50, 1.0 - _EXACT[i], reward_var=30.0 * i))


def test_tc_bin_tracker_matches_jax():
    """Snapshots on a new best R², restores the Tc head past the threshold:
    the port's encoder, restored in place, holds the JAX tree's values."""
    cfg = tiny_test_config()
    trees = param_trees(cfg)
    enc_tree = jax.tree.map(np.array, trees[0])
    encoder, _ = port_models(cfg, trees)
    jc, pc = _configs()
    jt, pt = j_sched.TcBinTracker(jc), schedulers.TcBinTracker(pc)
    rng = np.random.default_rng(0)
    for i, r2 in enumerate([0.5, 0.7, 0.65, 0.55, 0.58, 0.8, 0.5]):
        enc_tree = jt.update(enc_tree, r2)
        restored = pt.update(encoder, r2)
        assert restored == (i in (3, 4, 6))
        want = state_dict_from_flax(enc_tree)
        for name, v in encoder.state_dict().items():
            assert torch.equal(v, want[name]), (i, name)
        # a step moves every parameter, alike on both sides
        noise = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
                 for k, v in want.items()}
        with torch.no_grad():
            for name, p in encoder.named_parameters():
                p.add_(torch.from_numpy(noise[name]))
        encoder_sd = {k: v.clone() for k, v in encoder.state_dict().items()}
        enc_tree = {'params': _flax_from_sd(encoder_sd, enc_tree['params'])}
    assert pt.best_r2 == jt.best_r2
    fresh = schedulers.TcBinTracker(pc)
    fresh.load_state_dict(copy.deepcopy(pt.state_dict()))
    assert fresh.best_r2 == pt.best_r2 and fresh.snapshot.keys() == pt.snapshot.keys()


def _flax_from_sd(sd, like, prefix=()):
    """A port state dict back into the flax tree ``like``'s layout."""
    out = {}
    for k, v in like.items():
        if isinstance(v, dict):
            out[k] = _flax_from_sd(sd, v, prefix + (k,))
        else:
            name = '.'.join(prefix + ({'kernel': 'weight', 'scale': 'weight',
                                       'embedding': 'weight'}.get(k, k),))
            a = sd[name].numpy()
            out[k] = np.ascontiguousarray(a.T) if k == 'kernel' else a.copy()
    return out


# -- sampling and the data parts ----------------------------------------------

def test_weighted_epoch_sampler_streams_bit_equal():
    rng = np.random.default_rng(2)
    w = rng.random(301) ** 3
    for drop_last in (True, False):
        got = WeightedEpochSampler(w, batch_size=32, seed=4, drop_last=drop_last)
        want = j_sampler.WeightedEpochSampler(w, batch_size=32, seed=4, drop_last=drop_last)
        assert got.n_batches() == want.n_batches()
        for epoch in range(3):
            if epoch == 2:
                w2 = rng.random(301)
                got.set_weights(w2)
                want.set_weights(w2)
            a, b = list(got.epoch(epoch)), list(want.epoch(epoch))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                for host in range(4):
                    np.testing.assert_array_equal(shard_batch_indices(x, host, 4),
                                                  j_sampler.shard_batch_indices(y, host, 4))


def _small_corpus_csv(path, stride=90):
    """Every ``stride``-th row of the corpus (SC and non-SC rows alike), as a
    CSV of its own."""
    with gzip.open(CORPUS, 'rt', newline='') as f:
        rows = list(csv.reader(f))
    with open(path, 'w', newline='') as f:
        csv.writer(f).writerows([rows[0]] + rows[1::stride])
    return path


_FORMULAS = ['Y1Ba2Cu3O7', 'La(9/5)Sr(1/5)Cu1O4', 'Pb1', 'Hg1Ba2Ca2Cu3O8',
             'Mg0.9Al0.1B2', 'Fe1Se(1/2)Te(1/2)', 'Ba(3/5)K(2/5)Fe2As2', 'Nb3Sn1']


def _formula_csv(path):
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['formula', 'Tc', 'is_superconductor', 'category',
                    'requires_high_pressure', 'f0', 'f1'])
        for i, formula in enumerate(_FORMULAS):
            w.writerow([formula, 90.0 - 9 * i, 1 if i < 6 else 0,
                        'Cuprates' if i < 6 else 'Non-SC: Materials Project', 0,
                        0.5 * i, (i * 7) % 5])
    return path


def _assert_same_rows(got, want):
    assert got.formulas == want.formulas
    for name in ('tokens', 'element_indices', 'element_fractions', 'element_mask', 'tc',
                 'magpie', 'is_sc', 'label', 'hp', 'family', 'comp_targets', 'aug_group'):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize('which', ['formulas', 'corpus_rows'])
def test_order_augmentation_and_sample_weights_bit_equal(tmp_path, which):
    """load_dataset(order_augment=2) and resample_order_augmentation on a
    small CSV (eight formulas; every 90th corpus row) against the JAX
    loader (cache_dir=None), arrays and aug_group bit for bit, then
    compute_sample_weights with and without the augmentation."""
    path = (_formula_csv(tmp_path / 'f.csv') if which == 'formulas'
            else _small_corpus_csv(tmp_path / 'c.csv'))
    kw = dict(max_len=30, exclude_holdout=which == 'corpus_rows')
    base = load_dataset(path, **kw)
    _assert_same_rows(base, j_pipe.load_dataset(path, cache_dir=None, **kw))
    got = load_dataset(path, order_augment=2, order_augment_seed=3, **kw)
    want = j_pipe.load_dataset(path, cache_dir=None, order_augment=2, order_augment_seed=3,
                               **kw)
    _assert_same_rows(got, want)
    assert len(got) > len(base) and got.aug_group.max() == len(base) - 1
    for seed in (7, 8):
        _assert_same_rows(resample_order_augmentation(got, default_tokenizer(max_len=30), seed),
                          j_pipe.resample_order_augmentation(want, jax_tokenizer(max_len=30),
                                                             seed))
    for ds_p, ds_j in ((base, j_pipe.load_dataset(path, cache_dir=None, **kw)), (got, want)):
        for opts in (dict(), dict(balanced=False, oversample_high_tc=False),
                     dict(oversample_hard=False, tc_bins={30.0: 2.0})):
            a = compute_sample_weights(ds_p, **opts)
            b = j_pipe.compute_sample_weights(ds_j, **opts)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    sub = np.arange(0, len(got), 2)
    _assert_same_rows(got.subset(sub), want.subset(sub))


def test_sample_weights_on_synthetic_bit_equal():
    got, want = synthetic_dataset(n=300, seed=1), jax_synthetic(n=300, seed=1)
    for opts in (dict(), dict(balanced=False)):
        np.testing.assert_array_equal(compute_sample_weights(got, **opts),
                                      j_pipe.compute_sample_weights(want, **opts))


def test_canonical_ordering_matches_jax():
    formulas = _FORMULAS + ['C6H12O6', 'H2O', 'Cu', 'Xx2O', 'La(7/10)Sr(3/10)Cu(1)O4']
    for f in formulas:
        assert co.parse_ordered(f) == j_co.parse_ordered(f)
        for m in co.OrderingMethod:
            assert co.canonicalize(f, m) == j_co.canonicalize(f, j_co.OrderingMethod(m.value))
    assert co.canonicalize_batch(formulas) == j_co.canonicalize_batch(formulas)
    for f in formulas[:3]:
        assert co.to_abundance_order(f) == j_co.to_abundance_order(f)
        assert co.to_alphabetical_order(f) == j_co.to_alphabetical_order(f)
        assert co.to_electronegativity_order(f) == j_co.to_electronegativity_order(f)
    for k, inc in ((2, True), (4, False)):
        assert (co.OrderAugmentation(k, seed=11).augment_batch(formulas, inc)
                == j_co.OrderAugmentation(k, seed=11).augment_batch(formulas, inc))


def test_mastery_and_curriculum_match_jax():
    rng = np.random.default_rng(6)
    n = 200
    got, want = mastery_sampler.MasteryTracker(n), j_mastery.MasteryTracker(n)
    seq = rng.integers(3, 40, n)
    cur_p = mastery_sampler.CurriculumScheduler(seq, advance_patience=2)
    cur_j = j_mastery.CurriculumScheduler(seq, advance_patience=2)
    for step in range(12):
        idx = rng.choice(n, 64, replace=False)
        correct = rng.random(64) < (0.2 + 0.07 * step) * (1 if step != 8 else 0.1)
        got.update(idx, correct)
        want.update(idx, correct)
        np.testing.assert_array_equal(got.weights(), want.weights())
        np.testing.assert_array_equal(got.regressed(), want.regressed())
        cur_p.report_ar_exact(correct.astype(np.float64), idx)
        cur_j.report_ar_exact(correct.astype(np.float64), idx)
        np.testing.assert_array_equal(cur_p.get_sample_weights(), cur_j.get_sample_weights())
        assert cur_p.state_dict() == cur_j.state_dict()
    assert cur_p.active > 0


# -- manifest drift and auto-migration ----------------------------------------

@pytest.mark.parametrize('change', [
    dict(), dict(model=dict(d_model=48)), dict(model=dict(dropout=0.2)),
    dict(train=dict(learning_rate=1e-3)), dict(model=dict(vocab_size=4000),
                                               train=dict(batch_size=8))])
def test_manifest_drift_matches_jax(change):
    """The same config changes drift the same fields (the hashes are of
    each package's own configs, so only the field names are compared)."""
    cfg = tiny_test_config()
    tc_kw = dict(hungarian_enabled=False, use_round_trip=False)
    saved_p = check_manifest_drift({}, cfg, TrainConfig(**tc_kw))
    assert len(saved_p) == 3
    from superconductor_vae_tpu_torch.checkpoint import build_manifest
    from superconductor_vae_tpu.checkpoint import build_manifest as jax_manifest
    man_p = build_manifest(cfg, TrainConfig(**tc_kw))
    man_j = jax_manifest(jax_config(cfg), JaxTrainConfig(**tc_kw))
    cfg2 = dataclasses.replace(cfg, **change.get('model', {}))
    tc2 = dict(tc_kw, **change.get('train', {}))
    got = check_manifest_drift(man_p, cfg2, TrainConfig(**tc2))
    want = jax_drift(man_j, jax_config(cfg2), JaxTrainConfig(**tc2))
    assert [d.split(':')[0] for d in got] == [d.split(':')[0] for d in want]
    assert bool(got) == bool(change)


def test_auto_migrate_matches_jax():
    """An old checkpoint (vocab 4,000, a 12-wide Magpie input, a 12-wide
    physics-Z projection) migrated to tiny_test_config: the vocab and Magpie
    steps bit-equal to the JAX package's on the same numpy trees; the
    projection re-initialised to the new shape; the migrated modules'
    optimizer states dropped."""
    cfg = tiny_test_config()
    enc, dec = (jax.tree.map(np.array, t) for t in param_trees(cfg, seed=4))
    d, e = dec['params'], enc['params']
    d['token_embedding']['embedding'] = d['token_embedding']['embedding'][:4000]
    d['out_d2']['kernel'] = d['out_d2']['kernel'][:, :4000]
    d['out_d2']['bias'] = d['out_d2']['bias'][:4000]
    e['magpie_encoder']['Dense_0']['kernel'] = e['magpie_encoder']['Dense_0']['kernel'][:12]
    e['magpie_head']['Dense_1']['kernel'] = e['magpie_head']['Dense_1']['kernel'][:, :12]
    e['magpie_head']['Dense_1']['bias'] = e['magpie_head']['Dense_1']['bias'][:12]
    pz = {'kernel': np.ones((12, 62), np.float32), 'bias': np.zeros(62, np.float32)}
    want, want_act = jax_migrate(
        {'enc_params': copy.deepcopy(enc), 'dec_params': copy.deepcopy(dec),
         'pz_params': pz, 'enc_opt': [1], 'dec_opt': [2], 'pz_opt': [3], 'step': 5},
        {}, jax_config(cfg), tokenizer=jax_tokenizer(max_len=cfg.max_len), seed=3)
    got, got_act = auto_migrate(
        {'enc_params': state_dict_from_flax(enc), 'dec_params': state_dict_from_flax(dec),
         'pz_params': {'weight': torch.ones(62, 12), 'bias': torch.zeros(62)},
         'enc_opt': {}, 'dec_opt': {}, 'pz_opt': {}, 'step': 5},
        {}, cfg, tokenizer=default_tokenizer(max_len=cfg.max_len), seed=3)
    assert [a.split(' ')[0] for a in got_act] == [a.split(' ')[0] for a in want_act] == [
        'decoder', 'magpie', 'physics-Z']
    assert set(got) == set(want) == {'enc_params', 'dec_params', 'pz_params', 'step'}
    for key in ('enc_params', 'dec_params'):
        w = state_dict_from_flax(want[key])
        assert set(got[key]) == set(w)
        for name in w:
            assert got[key][name].dtype == torch.float32
            assert torch.equal(got[key][name], w[name]), (key, name)
    assert got['dec_params']['token_embedding.weight'].shape[0] == cfg.vocab_size
    assert got['pz_params']['weight'].shape == (62, cfg.magpie_dim)
    assert np.shape(want['pz_params']['kernel']) == (cfg.magpie_dim, 62)
    # the migrated payload loads into the current architecture
    encoder, decoder = port_models(cfg, param_trees(cfg))
    encoder.load_state_dict(got['enc_params'])
    decoder.load_state_dict(got['dec_params'])
    # nothing to migrate: the payload comes back as it was
    same, acts = auto_migrate({'enc_params': encoder.state_dict(),
                               'dec_params': decoder.state_dict()}, {}, cfg)
    assert acts == []


# -- topology and the latent cache --------------------------------------------

def test_topology_analyzer_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(400, 3)) @ rng.normal(size=(3, 32))
    is_sc = (rng.random(400) < 0.5).astype(np.int32)
    tc = np.abs(rng.normal(30, 20, 400))
    got = TopologyAnalyzer(n_clusters=4, output_dir=tmp_path / 'p').analyze(
        z, is_sc=is_sc, tc_kelvin=tc, epoch=3, full=True)
    want = JaxTopology(n_clusters=4, output_dir=tmp_path / 'j').analyze(
        z, is_sc=is_sc, tc_kelvin=tc, epoch=3, full=True)
    got.pop('time'), want.pop('time')
    assert got == want
    assert len(got['cluster_sizes']) == 4 and 'sc_boundary_ratio' in got
    a, b = (np.load(tmp_path / d / 'topology_full_3.npz') for d in ('p', 'j'))
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_latent_cache_matches_jax():
    """build_cache in batches of 16 (the last padded) against the JAX sweep
    on the same weights; the clusters of the cache are the same numpy on
    both sides."""
    cfg = tiny_test_config()
    trees = param_trees(cfg, seed=1)
    ds = synthetic_dataset(n=40, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim)
    want = JaxLatentAnalyzer(JaxEncoder(jax_config(cfg)), trees[0]).build_cache(
        jax_synthetic(n=40, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim), batch_size=16)
    encoder, _ = port_models(cfg, trees)
    encoder.train()
    got = LatentSpaceAnalyzer(encoder).build_cache(ds, batch_size=16)
    assert encoder.training                            # left as it was found
    for k in ('z', 'tc_pred'):
        g, w = getattr(got, k), getattr(want, k)
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5 * np.abs(w).max())
    for k in ('tc_kelvin', 'is_sc', 'family'):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.formulas == want.formulas
    cl_p = LatentSpaceAnalyzer(encoder).find_high_tc_clusters(got, k=3)
    cl_j = JaxLatentAnalyzer(None, None).find_high_tc_clusters(got, k=3)
    assert [c['n_members'] for c in cl_p] == [c['n_members'] for c in cl_j]


# -- gradient accumulation against optax.MultiSteps ----------------------------

def _inner(jstate):
    """A JAX state with each MultiSteps optimizer state replaced by its
    inner chain's, the layout the train-step helpers read."""
    return jstate.replace(**{k: getattr(jstate, k).inner_opt_state
                             for k in ('enc_opt', 'dec_opt', 'pz_opt')})


def _acc_leaves(jopt):
    return _leaves(jopt.acc_grads)


def test_accumulation_matches_optax_multisteps():
    cfg = _TINY
    enc_np, dec_np = param_trees(cfg, seed=0)
    pz_np = jax.tree.map(np.asarray, jax_init_proj(jax.random.PRNGKey(3), cfg.magpie_dim))
    ds = synthetic_dataset(n=32, seed=2, max_len=16, magpie_dim=16)
    batches = [ds.batch(np.arange(i * 8, (i + 1) * 8)) for i in range(4)]

    jtc = JaxTrainConfig(**TCFG, accumulation_steps=2)
    tx_enc, tx_dec = jts.make_optimizer(jtc), jts.make_optimizer(jtc)
    state = jts.TrainState(
        step=np.zeros((), np.int32), enc_params=enc_np, dec_params=dec_np,
        enc_opt=tx_enc.init(enc_np), dec_opt=tx_dec.init(dec_np),
        pz_params=pz_np, pz_opt=tx_enc.init(pz_np))
    jcfg = jax_config(cfg)
    step = jts.make_train_step(JaxEncoder(jcfg), JaxDecoder(jcfg), jtc, tx_enc, tx_dec,
                               jts.build_luts(jax_tokenizer(max_len=cfg.max_len)),
                               donate=False)
    dyn = dict(jts.default_dyn(jtc), physz_w=np.float32(1.0))
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for bt in batches:
        state, m = step(state, bt, jax.random.PRNGKey(0), dyn)
        states.append(jax.tree.map(np.asarray, state))
        metrics.append(jax.tree.map(np.asarray, m))

    tc = TrainConfig(**TCFG, accumulation_steps=2)
    pstep = make_train_step(tc, build_luts(default_tokenizer(max_len=cfg.max_len), 'cpu'))
    pdyn = dict(default_dyn(tc), physz_w=1.0)
    for cycle in (0, 1):                       # mini-steps 2c, 2c + 1; update t = c + 1
        start = states[2 * cycle]
        pstate = _port_state(_inner(start), cfg, tc)
        assert all(isinstance(opt, MultiSteps) and opt.mini_step == 0
                   for _, opt in pstate.groups())
        before = _port_params(pstate)
        for i in (2 * cycle, 2 * cycle + 1):
            pstate, m = pstep(pstate, _to_torch(batches[i]), 0, pdyn)
            assert pstate.step == i + 1
            got = {k: v.item() for k, v in m.items()}
            assert set(got) == set(metrics[i])
            for k in metrics[i]:
                np.testing.assert_allclose(got[k], metrics[i][k], **MET_TOL, err_msg=k)
            if i % 2 == 0:
                # between updates: params and AdamW unmoved, the mean kept
                after = _port_params(pstate)
                for g in range(3):
                    for k in before[g]:
                        assert np.array_equal(after[g][k], before[g][k]), k
                for (params, opt), module, name in zip(
                        pstate.groups(), (pstate.encoder, pstate.decoder, pstate.pz_proj),
                        ('enc_opt', 'dec_opt', 'pz_opt')):
                    jopt = getattr(states[i + 1], name)
                    assert opt.mini_step == int(jopt.mini_step) == 1
                    want = _acc_leaves(jopt)
                    got_acc = {n: a.numpy() for (n, _), a in
                               zip(module.named_parameters(), opt.acc_grads)}
                    _tree_close(got_acc, want, f'{name} accumulated gradient')
                    assert int(_adam_states(jopt.inner_opt_state).count) == cycle
                for k, v in _leaves(states[i + 1].enc_params).items():
                    assert np.array_equal(v, _leaves(start.enc_params)[k])
        check_moments_and_updates(before, _port_params(pstate), _port_moments(pstate),
                                  _inner(start), _inner(states[2 * cycle + 2]),
                                  tc.learning_rate, tc.weight_decay, cycle + 1)
        assert all(opt.mini_step == 0 for _, opt in pstate.groups())
