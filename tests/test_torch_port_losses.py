"""The loss modules of the port against the JAX package, on fixed random
model outputs and batches made with numpy (``multitask_loss`` with every
branch of its config, ``physics_z_loss``, ``theory_loss``, the A3/A6
constraints, the token statistics), and the host-side batch pieces
(``compositional_targets``, ``classify_batch``, ``category_to_label``) on
real rows of data/processed/jarvis_merged.csv.gz.

Tolerance: float32 on both sides; log-softmax over 4,752 classes and the
batch means sum in other orders, so losses, metrics and gradients agree to
2e-5 relative and 1e-6 absolute.  Integer and boolean results, the
compositional targets (the same numpy code) and the labels must be equal.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.data.compositional_targets import (
    compositional_targets as j_comp_targets,
    normalized_compositional_targets as j_norm_comp_targets)
from superconductor_vae_tpu.data.pipeline import category_to_label as j_category
from superconductor_vae_tpu.models.family_classifier import classify_batch as j_classify
from superconductor_vae_tpu.ops import constraints as j_con
from superconductor_vae_tpu.ops import losses as j_losses
from superconductor_vae_tpu.ops import physics_z_loss as j_pz
from superconductor_vae_tpu.ops import theory as j_theory
from superconductor_vae_tpu.ops import token_stats as j_ts
from superconductor_vae_tpu_torch.chem.elements import SYMBOL_TO_Z
from superconductor_vae_tpu_torch.data import (
    category_to_label, composition_slots, compositional_targets,
    normalized_compositional_targets, read_csv_rows)
from superconductor_vae_tpu_torch.models.family_classifier import classify_batch
from superconductor_vae_tpu_torch.ops import constraints, losses, physics_z_loss, theory
from superconductor_vae_tpu_torch.ops import token_stats
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer

import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
TOL = dict(rtol=2e-5, atol=1e-6)
B, T, V, M, L = 8, 30, 4752, 16, 2048
TOK = default_tokenizer(max_len=T)
# family-rich elements: every classify_batch rule fires on some row
_SYMBOLS = ['Cu', 'O', 'Y', 'Ba', 'La', 'Sr', 'Bi', 'Tl', 'Hg', 'Fe', 'As', 'P',
            'Se', 'Te', 'Mg', 'B', 'U', 'Ce', 'C', 'H', 'N', 'S', 'Ca', 'Nb', 'Sn']


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), **(tol or TOL))


def _compositions(rng, b):
    n_el = rng.integers(1, 8, b)
    mask = np.arange(12)[None, :] < n_el[:, None]
    idx = np.array([[SYMBOL_TO_Z[s] for s in rng.choice(_SYMBOLS, 12, replace=False)]
                    for _ in range(b)], np.int32) * mask
    frac = rng.random((b, 12)).astype(np.float32) * mask
    return idx, (frac / frac.sum(1, keepdims=True)).astype(np.float32), mask


def _tokens(rng, b):
    """Half real formulas, half random element/subscript streams with
    repeated elements (site duplicates) and PAD tails."""
    rows = read_csv_rows(CSV, b // 2)
    real = TOK.encode_batch(rows['formula'])
    rand = np.zeros((b - b // 2, T), np.int64)
    for r in range(len(rand)):
        n = rng.integers(4, T - 2)
        body = rng.choice(np.r_[5:15, 123:130, 143:160], n)
        rand[r, :n + 2] = np.r_[1, body, 2]
    return np.concatenate([real, rand]).astype(np.int64)


def _batch_and_outputs(seed):
    rng = np.random.default_rng(seed)
    idx, frac, mask = _compositions(rng, B)
    fam_probs = rng.random((B, 14)).astype(np.float32)
    fam_probs[:4, [2, 3, 8, 10]] += np.eye(4, dtype=np.float32) * 40   # confident rows
    fam_probs /= fam_probs.sum(1, keepdims=True)
    batch = {
        'element_indices': idx, 'element_fractions': frac, 'element_mask': mask,
        'magpie': rng.standard_normal((B, M)).astype(np.float32),
        'tc': rng.standard_normal(B).astype(np.float32),
        'tokens': _tokens(rng, B),
        'is_sc': (rng.random(B) < 0.7).astype(np.int32),
        'hp': (rng.random(B) < 0.3).astype(np.float32),
        'family': rng.integers(0, 14, B).astype(np.int32),
        'comp_targets': rng.standard_normal((B, 15)).astype(np.float32),
    }
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    enc_out = {
        'tc_pred': f32(B), 'tc_class_logits': f32(B, 5), 'magpie_pred': f32(B, M),
        'fraction_pred': f32(B, 12), 'element_count_pred': f32(B) * 3,
        'kl_loss': np.float32(0.7), 'z': f32(B, L), 'hp_pred': f32(B), 'sc_pred': f32(B),
        'family_coarse_logits': f32(B, 7), 'family_cuprate_sub_logits': f32(B, 6),
        'family_iron_sub_logits': f32(B, 2), 'family_composed_14': fam_probs,
    }
    dec_out = {'logits': f32(B, T - 1, V) * 3, 'stop_logits': f32(B, T - 1),
               'type_logits': f32(B, T - 1, 5), 'site_dup_logits': f32(B, T - 1)}
    return batch, enc_out, dec_out


def _torch(tree, grad=()):
    out = {}
    for k, v in tree.items():
        t = torch.as_tensor(np.asarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        if k in grad:
            t.requires_grad_()
        out[k] = t
    return out


LOSS_CONFIGS = {
    'default': j_losses.LossConfig(),
    'semantic_and_overrides': j_losses.LossConfig(semantic_unit_weight=0.5, rl_weight=0.3),
    'plain_branches': j_losses.LossConfig(
        tc_huber_delta=0.0, tc_underpred_penalty=1.0, tc_relative_weight=0.0,
        tc_kelvin_weighting=False, tc_log_transform=False, tc_mean=1.0, tc_std=2.0,
        use_length_weighting=False, use_element_count_weighting=False,
        label_smoothing=0.0, fraction_token_weight=1.0, stop_end_position_weight=1.0,
        constraint_zoo_weight=0.0, use_z_norm_penalty=False),
}
GRAD_KEYS = ('tc_pred', 'z', 'fraction_pred', 'logits', 'stop_logits')


@pytest.mark.parametrize('name', sorted(LOSS_CONFIGS))
def test_multitask_loss_matches_jax(name):
    jcfg = LOSS_CONFIGS[name]
    cfg = losses.LossConfig(**dataclasses.asdict(jcfg))
    batch, enc_out, dec_out = _batch_and_outputs(seed=len(name))
    type_table = TOK.token_type_table
    kw = dict(rl_loss=np.float32(0.25), rl_reward_mean=np.float32(3.0),
              dyn={'physz_w': 0.7, 'm_magpie': 0.0, 'tc_w': 5.0},
              physz_loss=np.float32(1.5))
    if name == 'semantic_and_overrides':
        kw.update(dyn=None, tc_weight_override=3.0, magpie_weight_override=0.5)

    def jax_total(e, d):
        return j_losses.multitask_loss(jcfg, e, d, batch, jnp.asarray(type_table), **kw)
    (want_total, want), grads = jax.jit(jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in enc_out.items()},
        {k: jnp.asarray(v) for k, v in dec_out.items()})

    e, d = _torch(enc_out, GRAD_KEYS), _torch(dec_out, GRAD_KEYS)
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.floating) else v for k, v in kw.items()}
    total, got = losses.multitask_loss(cfg, e, d, _torch(batch),
                                       torch.as_tensor(type_table), **tkw)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])
    _close(total, want_total)
    total.backward()
    for tree, jgrad in ((e, grads[0]), (d, grads[1])):
        for key in GRAD_KEYS:
            if key in tree:
                g = tree[key].grad                           # None: not on the loss's path
                _close(torch.zeros_like(tree[key]) if g is None else g, jgrad[key],
                       rtol=2e-5, atol=1e-7)


def test_semantic_unit_loss_matches_jax():
    rng = np.random.default_rng(7)
    targets = _tokens(rng, B)[:, 1:]
    pred = targets.copy()
    flip = rng.random(pred.shape) < 0.2
    pred[flip] = rng.choice(np.r_[2, 5:15, 123:130, 143:160], flip.sum())
    mask = targets != 0
    want = j_losses.semantic_unit_loss(jnp.asarray(pred), jnp.asarray(targets),
                                       jnp.asarray(mask), jnp.asarray(TOK.token_type_table))
    got = losses.semantic_unit_loss(torch.as_tensor(pred), torch.as_tensor(targets),
                                    torch.as_tensor(mask),
                                    torch.as_tensor(TOK.token_type_table).long())
    for key in want:
        _close(got[key], want[key])


@pytest.mark.parametrize('learnable', [True, False])
def test_physics_z_loss_matches_jax(learnable):
    rng = np.random.default_rng(11)
    z = (rng.standard_normal((B, L)) * 2).astype(np.float32)
    z[:, :520] = np.abs(z[:, :520]) + 0.005 * (rng.random((B, 520)) < 0.3)  # clamps fire
    comp = rng.standard_normal((B, 15)).astype(np.float32)
    magpie = rng.standard_normal((B, M)).astype(np.float32)
    tc = rng.standard_normal(B).astype(np.float32)
    params = ({'kernel': (rng.standard_normal((M, 62)) / 4).astype(np.float32),
               'bias': (rng.standard_normal(62) / 4).astype(np.float32)}
              if learnable else None)

    def jax_total(z_, p_):
        out = j_pz.physics_z_loss(z_, comp, magpie, tc, proj_params=p_)
        return out['total'], out
    (_, want), (gz, gp) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), params)

    proj = None
    if learnable:
        proj = torch.nn.Linear(M, 62)
        with torch.no_grad():
            proj.weight.copy_(torch.as_tensor(params['kernel'].T))
            proj.bias.copy_(torch.as_tensor(params['bias']))
    tz = torch.tensor(z, requires_grad=True)
    got = physics_z_loss.physics_z_loss(tz, torch.as_tensor(comp), torch.as_tensor(magpie),
                                        torch.as_tensor(tc), proj=proj)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])
    got['total'].backward()
    _close(tz.grad, gz, rtol=2e-5, atol=1e-8)
    if learnable:
        _close(proj.weight.grad.T, gp['kernel'], rtol=2e-5, atol=1e-8)
        _close(proj.bias.grad, gp['bias'], rtol=2e-5, atol=1e-8)


def test_theory_and_constraint_losses_match_jax():
    batch, enc_out, _ = _batch_and_outputs(seed=5)
    tc_k = np.abs(enc_out['tc_pred']) * 80                      # up to ~200 K
    fam = np.arange(B, dtype=np.int32) % 14 + np.array([0, 0, 0, 0, 4, 4, 4, 4])
    j_args = [jnp.asarray(batch[k]) for k in
              ('element_fractions', 'element_indices', 'element_mask')]
    want = j_theory.theory_loss(jnp.asarray(tc_k), jnp.asarray(fam), *j_args)
    t = _torch(batch)
    got = theory.theory_loss(torch.as_tensor(tc_k), torch.as_tensor(fam).long(),
                             t['element_fractions'], t['element_indices'],
                             t['element_mask'])
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])

    args_j = [jnp.asarray(batch[k]) for k in
              ('element_indices', 'element_fractions', 'element_mask')]
    args_t = [t[k] for k in ('element_indices', 'element_fractions', 'element_mask')]
    probs = enc_out['family_composed_14']
    a3 = constraints.site_occupancy_loss(*args_t, torch.as_tensor(probs))
    assert float(a3) > 0                                        # some rule applies
    _close(a3, j_con.site_occupancy_loss(*args_j, jnp.asarray(probs)))
    assert float(constraints.site_occupancy_loss(*args_t, None)) == 0.0
    for tol in (0.5, 0.1):
        _close(constraints.charge_balance_loss(*args_t, tolerance=tol),
               j_con.charge_balance_loss(*args_j, tolerance=tol))


def test_token_stats_match_jax():
    rng = np.random.default_rng(3)
    tokens = _tokens(rng, B)
    mask = (tokens != 0).astype(np.float32)
    luts = {k: getattr(TOK, k) for k in ('token_to_element_z', 'token_value_table')}
    jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    z_j, z_t = jnp.asarray(luts['token_to_element_z']), torch.as_tensor(luts['token_to_element_z'])
    v_j, v_t = jnp.asarray(luts['token_value_table']), torch.as_tensor(luts['token_value_table'])
    _close(token_stats.next_token_quantity(tt, tm, v_t), j_ts.next_token_quantity(jt, jm, v_j))
    _close(token_stats.element_amounts(tt, tm, z_t, v_t), j_ts.element_amounts(jt, jm, z_j, v_j))
    np.testing.assert_array_equal(token_stats.element_counts(tt, tm, z_t).numpy(),
                                  np.asarray(j_ts.element_counts(jt, jm, z_j)))
    vals, present = token_stats.integer_subscripts(tt, tm)
    j_vals, j_present = j_ts.integer_subscripts(jt, jm)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(present.numpy(), np.asarray(j_present))
    for name in ('is_element_token', 'is_integer_token'):
        np.testing.assert_array_equal(getattr(token_stats, name)(tt).numpy(),
                                      np.asarray(getattr(j_ts, name)(jt)))
    np.testing.assert_array_equal(token_stats.stream_has_fraction(tt, tm).numpy(),
                                  np.asarray(j_ts.stream_has_fraction(jt, jm)))
    np.testing.assert_array_equal(token_stats.first_eos_position(tt, tm).numpy(),
                                  np.asarray(j_ts.first_eos_position(jt, jm)))


@pytest.fixture(scope='module')
def csv_rows():
    return read_csv_rows(CSV, 3000)


def test_compositional_targets_and_families_on_real_rows(csv_rows):
    idx, frac, mask = composition_slots(csv_rows['formula'])
    np.testing.assert_array_equal(compositional_targets(idx, frac, mask),
                                  j_comp_targets(idx, frac, mask))
    got, got_stats = normalized_compositional_targets(idx, frac, mask)
    want, want_stats = j_norm_comp_targets(idx, frac, mask)
    np.testing.assert_array_equal(got, want)
    assert got_stats == want_stats
    fam = classify_batch(idx, mask)
    np.testing.assert_array_equal(fam, j_classify(idx, mask))
    rng = np.random.default_rng(9)
    idx2, _, mask2 = _compositions(rng, 4000)
    fam2 = classify_batch(idx2, mask2)
    np.testing.assert_array_equal(fam2, j_classify(idx2, mask2))
    assert set(np.unique(fam2)) == set(range(1, 14))            # every rule fired


def test_category_labels_on_every_csv_category():
    rows = read_csv_rows(CSV, 10 ** 6)
    cats = sorted(set(rows['category'])) + ['Non-SC: Unlisted', 'Something else']
    assert len(cats) >= 9
    for c in cats:
        for hp in (0, 1):
            for ext in (True, False):
                assert category_to_label(c, ext, hp) == j_category(c, ext, hp), (c, hp, ext)
    labels = [category_to_label(c, requires_high_pressure=int(h))
              for c, h in zip(rows['category'], rows['hp'])]
    want = [j_category(c, requires_high_pressure=int(h))
            for c, h in zip(rows['category'], rows['hp'])]
    assert labels == want
