"""The train step of the port against the JAX package's ``make_train_step``:
one and two steps from the same parameters (flax trees through
``params_from_jax``, with the physics-Z projection) on real rows of
data/processed/jarvis_merged.csv.gz, with ``TrainConfig`` as bench.py
builds it (batch 256 there, 4 rows here; physics-Z with the learnable
projection; the set decoder and the round-trip loss off), dropout 0 and
``physz_w`` 1.

Widths: ``tiny_test_config`` with a 512-wide latent (the physics-Z blocks
end at coordinate 512, so the JAX loss needs at least that), and run4's
widths with one decoder layer.

What is compared, after each of the two steps (two different batches):
- every metric of the JAX step (the 17-term loss, its accuracy and entropy
  metrics, the theory loss and ``grad_norm``);
- the clipped gradient of every parameter, through the first AdamW moment
  (``mu = (1 - b1) * g`` after one step), and each tree's norm of it;
- the updated parameters, as the change each step made, and both AdamW
  moments of every parameter.

With ``grad_clip`` 1 the encoder's and the decoder's gradients (norms in
the hundreds and tens) are clipped and the projection's (below 1) is not;
the test asserts so.  One clip group instead of three would scale the
projection's gradient by about 1/300 and fail the moment check by far.
``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6, a difference of
1e-6 / norm relative, below float32 parity at these norms; so a third run
('tiny_loss_x1e-6') scales every term weight of the loss, and grad_clip,
by 1e-6: the same step at gradient norms of 1e-4 and below, where that
epsilon moves the moments by 0.3% and more.

Tolerance: float32 on both sides, other summation orders (and flax's
LayerNorm variance formula), so metrics agree to 1e-4 relative; the AdamW
moments to 1e-3 relative plus 1e-4 of the largest magnitude in their tree
(a few elements near zero carry the summation noise of the whole tree: up
to 2.2e-5 of the largest was seen); the parameter changes to 1.5 ulp of
the parameter of the AdamW rule applied to the port's own moments (tight
enough to see the weight decay, 2.5 ulp), and to 2e-3 (plus 2.5 ulp) of
JAX's changes wherever the two sides' moments agree to 1e-3, which must
be at least 95% of the elements.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.ops.physics_z_loss import init_magpie_proj as jax_init_proj
from superconductor_vae_tpu_torch.ops.physics_z_loss import init_magpie_proj
from superconductor_vae_tpu.training import train_step as jts
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu_torch.checkpoint import params_from_jax
from superconductor_vae_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from superconductor_vae_tpu_torch.data import (
    category_to_label, composition_slots, normalized_compositional_targets, read_csv_rows)
from superconductor_vae_tpu_torch.models import (
    SetDecoderLayer, config_from_meta, tiny_test_config)
from superconductor_vae_tpu_torch.models.family_classifier import classify_batch
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    TrainConfig, TrainState, build_luts, clip_by_global_norm_, create_train_state,
    default_dyn, make_train_step)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import jax_config, param_trees

ROOT = Path(__file__).resolve().parents[1]
META = json.loads((ROOT / 'results/run4/ckpt_snapshot/meta.json').read_text())
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
_TINY = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0)
# (model config, loss scale): the scaled run multiplies every term weight of
# the total loss (and grad_clip) by 1e-6, so that gradient norms are small
# enough for torch's clip_grad_norm_ (norm + 1e-6) to differ from optax's rule
CONFIGS = {
    'tiny': (_TINY, 1.0),
    'tiny_loss_x1e-6': (_TINY, 1e-6),
    'run4_1layer': (config_from_meta(META['model_config'], num_layers=1, dropout=0.0), 1.0),
}
_TERM_WEIGHTS = ('ce_weight', 'kl_weight', 'stoich_weight', 'element_count_weight',
                 'tc_class_weight', 'hp_loss_weight', 'sc_loss_weight', 'stop_loss_weight',
                 'token_type_loss_weight', 'site_dup_loss_weight', 'family_loss_weight',
                 'constraint_zoo_weight', 'z_norm_penalty_weight')
B = 4
TCFG = dict(use_physics_z=True, magpie_proj_learnable=True,
            hungarian_enabled=False, use_round_trip=False)
MET_TOL = dict(rtol=1e-4, atol=1e-6)
B1, B2 = 0.9, 0.999


def _batches(cfg):
    """Two batches of 4 CSV rows (non-SC and SC), as the data pipeline
    builds them; Tc, Magpie and the compositional targets z-scored over
    the 8 rows (a stand-in for NormStats, which the data slice ports)."""
    rows = read_csv_rows(CSV, 2 * B)
    idx, frac, mask = composition_slots(rows['formula'])
    is_sc = rows['is_sc']
    tc = np.log1p(rows['tc'])
    tc = ((tc - tc[is_sc == 1].mean()) / (tc[is_sc == 1].std() + 1e-8)).astype(np.float32)
    mg = np.nan_to_num(rows['magpie'][:, :cfg.magpie_dim].astype(np.float64))
    mg = ((mg - mg.mean(0)) / (mg.std(0) + 1e-8)).astype(np.float32)
    if mg.shape[1] < cfg.magpie_dim:
        mg = np.pad(mg, ((0, 0), (0, cfg.magpie_dim - mg.shape[1])))
    full = {
        'element_indices': idx, 'element_fractions': frac, 'element_mask': mask,
        'magpie': mg, 'tc': tc,
        'tokens': default_tokenizer(max_len=cfg.max_len).encode_batch(
            rows['formula']).astype(np.int32),
        'is_sc': is_sc, 'hp': rows['hp'],
        'family': np.where(is_sc == 1, classify_batch(idx, mask), 0).astype(np.int32),
        'comp_targets': normalized_compositional_targets(idx, frac, mask)[0],
        'label': np.array([category_to_label(c, requires_high_pressure=int(h))
                           for c, h in zip(rows['category'], rows['hp'])], np.int32),
    }
    return [{k: v[i * B:(i + 1) * B] for k, v in full.items()} for i in range(2)]


def _to_torch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype in (np.int32, np.int64)
            else torch.as_tensor(v) for k, v in batch.items()}


def _leaves(tree):
    """A flax tree (or optax moment tree) as {torch parameter name: array
    in torch layout}."""
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


def _adam_states(opt_state):
    """The ScaleByAdamState inside ``chain(clip, inject_hyperparams(adamw))``."""
    inner = opt_state[1].inner_state
    return next(s for s in inner if hasattr(s, 'mu'))


def _scaled(tc, scale):
    """``tc`` with every term weight of the total loss, and grad_clip,
    multiplied by ``scale`` (physz_w rides in dyn)."""
    if scale == 1.0:
        return tc
    loss = dataclasses.replace(tc.loss, **{k: getattr(tc.loss, k) * scale
                                           for k in _TERM_WEIGHTS})
    return dataclasses.replace(tc, loss=loss, tc_weight=tc.tc_weight * scale,
                               magpie_weight=tc.magpie_weight * scale,
                               grad_clip=tc.grad_clip * scale)


def _modules(state):
    """The state's modules in the order of its groups."""
    return [m for m in (state.encoder, state.decoder, state.pz_proj, state.set_decoder)
            if m is not None]


def _port_state(jstate, cfg, tc):
    """A port TrainState holding the JAX state's parameters and AdamW
    moments (and step counts); with the JAX state's set decoder, the port's
    runs without dropout (the tests build JAX's so)."""
    encoder, decoder, proj, *set_dec = params_from_jax(
        jstate.enc_params, jstate.dec_params, cfg, device='cpu',
        pz_params=jstate.pz_params, set_params=jstate.set_params)
    set_dec = set_dec[0] if set_dec else None
    if set_dec is not None:
        for layer in set_dec.children():
            if isinstance(layer, SetDecoderLayer):
                layer.dropout = 0.0
    state = TrainState.from_modules(encoder, decoder, tc, proj, step=int(jstate.step),
                                    set_decoder=set_dec)
    for (params, opt), module, jopt in zip(
            state.groups(), _modules(state),
            (jstate.enc_opt, jstate.dec_opt, jstate.pz_opt, jstate.set_opt)):
        adam = _adam_states(jopt)
        mu, nu = _leaves(adam.mu), _leaves(adam.nu)
        for name, p in module.named_parameters():
            opt.state[p] = {'step': torch.tensor(float(adam.count)),
                            'exp_avg': torch.tensor(mu[name]),
                            'exp_avg_sq': torch.tensor(nu[name])}
    return state


def _port_params(state):
    return [{k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
            for m in _modules(state)]


def _port_moments(state):
    out = []
    for (params, opt), module in zip(state.groups(), _modules(state)):
        out.append({n: (opt.state[p]['exp_avg'].numpy().copy(),
                        opt.state[p]['exp_avg_sq'].numpy().copy())
                    for n, p in module.named_parameters()})
    return out


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def runs(request):
    """Two chained JAX steps (states S0 -> S1 -> S2), and the port's step i
    from the JAX state S(i-1) on the same batch.  Each port step starts from
    the JAX state rather than from the port's previous step: AdamW's first
    update, lr * g / (|g| + eps), turns float32 noise in gradients near
    zero into full-size sign flips of a few parameter changes, which a
    chained run would carry into the next step's gradients."""
    cfg, scale = CONFIGS[request.param]
    enc_np, dec_np = param_trees(cfg, seed=0)
    pz_np = jax.tree.map(np.asarray, jax_init_proj(jax.random.PRNGKey(3), cfg.magpie_dim))
    batches = _batches(cfg)

    # the JAX step
    jtc = _scaled(JaxTrainConfig(**TCFG), scale)
    jcfg = jax_config(cfg)
    tx_enc, tx_dec = jts.make_optimizer(jtc), jts.make_optimizer(jtc)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), enc_params=enc_np, dec_params=dec_np,
        enc_opt=tx_enc.init(enc_np), dec_opt=tx_dec.init(dec_np),
        pz_params=pz_np, pz_opt=tx_enc.init(pz_np))
    step = jts.make_train_step(JaxEncoder(jcfg), JaxDecoder(jcfg), jtc, tx_enc, tx_dec,
                               jts.build_luts(jax_tokenizer(max_len=cfg.max_len)),
                               donate=False)
    dyn = dict(jts.default_dyn(jtc), physz_w=jnp.asarray(scale, jnp.float32))
    jax_states, jax_metrics = [jax.tree.map(np.asarray, state)], []
    for bt in batches:
        state, metrics = step(state, bt, jax.random.PRNGKey(0), dyn)
        jax_states.append(jax.tree.map(np.asarray, state))
        jax_metrics.append(jax.tree.map(np.asarray, metrics))

    # the port's step from the same states
    tc = _scaled(TrainConfig(**TCFG), scale)
    pstep = make_train_step(tc, build_luts(default_tokenizer(max_len=cfg.max_len), 'cpu'))
    pdyn = dict(default_dyn(tc), physz_w=float(np.float32(scale)))
    port_runs = []
    for i, bt in enumerate(batches):
        pstate = _port_state(jax_states[i], cfg, tc)
        before = _port_params(pstate)
        pstate, metrics = pstep(pstate, _to_torch(bt), 0, pdyn)
        assert pstate.step == i + 1
        port_runs.append((before, _port_params(pstate), _port_moments(pstate),
                          {k: v.item() for k, v in metrics.items()}))
    return dict(jax_states=jax_states, jax_metrics=jax_metrics, port=port_runs,
                lr=tc.learning_rate, wd=tc.weight_decay, clip=tc.grad_clip)


def _tree_close(got, want, what):
    scale = max(np.abs(w).max() for w in want.values())
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=f'{what}: {k}')


@pytest.mark.parametrize('i', [0, 1])
def test_metrics_match_jax(runs, i):
    want = runs['jax_metrics'][i]
    got = runs['port'][i][3]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **MET_TOL, err_msg=key)


def test_clip_is_active_for_encoder_and_decoder_only(runs):
    """The premise of the clip checks: enc and dec clipped, the projection not."""
    for metrics in runs['jax_metrics']:
        assert metrics['grad_norm'] > 10.0 * runs['clip']
    st = runs['jax_states'][1]
    for opt, clipped in ((st.enc_opt, True), (st.dec_opt, True), (st.pz_opt, False)):
        mu = jax.tree.leaves(_adam_states(opt).mu)
        norm = np.sqrt(sum((np.asarray(m, np.float64) ** 2).sum() for m in mu)) / (1 - B1)
        if clipped:
            assert abs(norm / runs['clip'] - 1.0) < 1e-4    # scaled to grad_clip exactly
        else:
            assert 0.05 < norm / runs['clip'] < 0.99


def check_moments_and_updates(before, params, moments, jprev, jnext, lr, wd, t,
                              names=('enc', 'dec', 'pz')):
    """The port's step against the JAX step from the same state ``jprev``:
    the AdamW moments of each group (``names``, in the order of ``before``,
    ``params`` and ``moments``) against ``jnext``'s, the clipped gradient's
    norm (at t=1), and each parameter change against the AdamW rule on the
    port's own moments and against JAX's change."""
    for g, name in enumerate(names):
        adam = _adam_states(getattr(jnext, f'{name}_opt'))
        assert int(adam.count) == t
        want_mu, want_nu = _leaves(adam.mu), _leaves(adam.nu)
        got_mu = {k: v[0] for k, v in moments[g].items()}
        got_nu = {k: v[1] for k, v in moments[g].items()}
        _tree_close(got_mu, want_mu, f'{name} mu, step {t}')
        _tree_close(got_nu, want_nu, f'{name} nu, step {t}')
        if t == 1:
            # mu / (1 - b1) is the clipped gradient; its norm per tree is
            # grad_clip (enc, dec) or the projection's own
            norms = [np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in tree.values()))
                     / (1 - B1) for tree in (got_mu, want_mu)]
            np.testing.assert_allclose(norms[0], norms[1], rtol=1e-4)

        jp_prev = _leaves(getattr(jprev, f'{name}_params'))
        want_delta = {k: v - jp_prev[k]
                      for k, v in _leaves(getattr(jnext, f'{name}_params')).items()}
        checked = 0
        for k, want_d in want_delta.items():
            got_d = params[g][k] - before[g][k]
            # the AdamW rule on the port's own moments, in float64
            m_hat = got_mu[k] / (1 - B1 ** t)
            v_hat = got_nu[k] / (1 - B2 ** t)
            rule = -lr * (m_hat / (np.sqrt(v_hat) + 1e-8) + wd * before[g][k])
            # float32 rounds the new parameter once or twice: 1.5 ulp of
            # |p| (the decay, lr * wd * |p|, is 2.5 ulp), plus 1e-5 of the
            # update for the float32 moment arithmetic
            ulp = np.finfo(np.float32).eps * np.abs(before[g][k])
            bad = np.abs(got_d - rule) > 1.5 * ulp + 1e-5 * np.abs(rule) + 1e-12
            assert not bad.any(), (f'{name} AdamW rule, step {t}: {k}: {bad.sum()} of '
                                   f'{bad.size} elements off')
            # against JAX where the two sides' moments agree to 1e-3 (the
            # rest are near their tree's float32 noise, held by the moment
            # check above): the update m / sqrt(v) then agrees to 2e-3,
            # plus the rounding of the new parameter on each side (2.5 ulp)
            same = ((np.abs(got_mu[k] - want_mu[k]) <= 1e-3 * np.abs(want_mu[k]))
                    & (np.abs(got_nu[k] - want_nu[k]) <= 1e-3 * want_nu[k]))
            bad = same & (np.abs(got_d - want_d) > 2e-3 * np.abs(want_d) + 2.5 * ulp)
            assert not bad.any(), (f'{name} parameter change, step {t}: {k}: {bad.sum()} '
                                   f'of {same.sum()} elements off')
            checked += int(same.sum())
        n = sum(v.size for v in want_delta.values())
        assert checked >= 0.95 * n, f'{name} step {t}: only {checked} of {n} updates checked'


@pytest.mark.parametrize('i', [0, 1])
def test_gradients_moments_and_params_match_jax(runs, i):
    before, params, moments, _ = runs['port'][i]
    check_moments_and_updates(before, params, moments, runs['jax_states'][i],
                              runs['jax_states'][i + 1], runs['lr'], runs['wd'], i + 1)


def test_clip_by_global_norm_is_the_optax_rule():
    """Port's clip against optax at norms where torch's clip_grad_norm_
    (which divides by norm + 1e-6) differs: above, at and below max_norm."""
    rng = np.random.default_rng(0)
    shapes = [(3, 5), (7,), (2, 2, 2)]
    for norm_target, max_norm in ((3e-6, 1e-6), (0.5, 1.0), (2.0, 1.0)):
        tree = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        scale = norm_target / np.sqrt(sum((t ** 2).sum() for t in tree))
        tree = [(t * scale).astype(np.float32) for t in tree]
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(t) for t in tree], optax.EmptyState())
        got = [torch.tensor(t) for t in tree]
        norm = clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(float(norm), norm_target, rtol=1e-5)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        theirs = [torch.tensor(t, requires_grad=True) for t in tree]
        for t, g in zip(theirs, tree):
            t.grad = torch.tensor(g)
        torch.nn.utils.clip_grad_norm_(theirs, max_norm)
        differs = any(not np.allclose(t.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)
                      for t, w in zip(theirs, want))
        assert differs == (max_norm < 1e-3)          # its epsilon shows at small norms


def test_train_config_mirrors_jax():
    assert ([f.name for f in dataclasses.fields(TrainConfig)]
            == [f.name for f in dataclasses.fields(JaxTrainConfig)])
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
    kw = dict(TCFG, batch_size=256, learning_rate=1e-4, grad_clip=0.5)
    assert dataclasses.asdict(TrainConfig(**kw)) == dataclasses.asdict(JaxTrainConfig(**kw))
    want = jts.default_dyn(JaxTrainConfig())                 # float32 arrays
    assert {k: np.float32(v) for k, v in default_dyn(TrainConfig()).items()} == {
        k: np.float32(v) for k, v in want.items()}


def test_default_train_config_builds_and_runs_a_step():
    """``TrainConfig()`` as it stands (the set decoder and the round-trip
    loss on) builds a state with four update groups and a step that runs
    and reports the new terms."""
    tc = TrainConfig()
    assert tc.hungarian_enabled and tc.use_round_trip and tc.a5_weight > 0
    cfg = dataclasses.replace(tiny_test_config(), latent_dim=512)
    state = create_train_state(cfg, tc, seed=0, device='cpu')
    assert state.set_decoder is not None and len(state.groups()) == 4
    luts = build_luts(default_tokenizer(max_len=cfg.max_len), 'cpu')
    state, m = make_train_step(tc, luts)(state, _to_torch(_batches(cfg)[0]), 0,
                                         default_dyn(tc))
    for key in ('a5_z_mse', 'a5_tc_mse', 'hungarian_loss', 'set_element_accuracy',
                'set_exact', 'grad_norm', 'total'):
        assert torch.isfinite(m[key]), key
    assert state.step == 1 and all(len(opt.state) > 0 for _, opt in state.groups())


def test_dropout_masks_follow_seed_and_step():
    """With dropout on, a step is reproducible from (seed, step) and the
    global generator is left as it was."""
    cfg = dataclasses.replace(tiny_test_config(), latent_dim=512)
    tc = TrainConfig(**TCFG)
    luts = build_luts(default_tokenizer(max_len=cfg.max_len), 'cpu')
    bt = _to_torch(_batches(cfg)[1])
    step = make_train_step(tc, luts)
    losses = []
    for seed in (5, 5, 6):
        state = create_train_state(cfg, tc, seed=0, device='cpu')
        rng_before = torch.random.get_rng_state()
        _, m = step(state, bt, seed, default_dyn(tc))
        assert torch.equal(torch.random.get_rng_state(), rng_before)
        losses.append(m['total'].item())
    assert losses[0] == losses[1] != losses[2]
    assert state.step == 1


@pytest.mark.parametrize('entry', [
    lambda: create_train_state(_TINY, TrainConfig(**TCFG)),
    lambda: init_magpie_proj(torch.Generator(), 16),
])
def test_cuda_default_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry()
