"""The A5 round trip and the train step at ``TrainConfig()``'s defaults in
the port against the JAX package (ops/round_trip.py, training/train_step.py).

- ``tokens_to_composition``: bit-equal to JAX's on token streams built to
  tie (every zero amount ties; NbN, Fe2Se2 and Fe0.5Se0.5 tie among real
  elements too) and on random streams.
- ``round_trip_loss`` over 8 rows from the same numpy parameters and
  inputs, the encoder's outputs feeding it as in the step: the loss and
  its two terms (1e-4 relative), the encoder's gradient (1e-3 relative
  plus 1e-4 of the largest), and the decoder's, exactly zero in both
  packages (the rollout's outputs are integers).
- Two train steps at ``TrainConfig()``'s defaults (the set decoder, the
  round trip with a greedy rollout of max(int(0.1 B), 1) rows, physics-Z
  with the learnable projection; ``physz_w`` 1, dropout 0 in every model,
  the set decoder's too) at ``tiny_test_config`` widths with a 512-wide
  latent on the real rows of tests/test_torch_port_train_step.py, each
  port step from the JAX state before it, through ``make_train_step`` and
  through ``make_epoch_runner``: every metric (1e-4 relative), then the
  AdamW moments (the clipped gradients) and the updated parameters of the
  encoder, decoder, projection and set decoder, at the tolerances of
  tests/test_torch_port_train_step.py.  JAX runs its rollout with
  ``pallas_decode=False``: with its Pallas kernel the step raises
  (``JVP with aliasing not supported``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.generation import GenerationConfig as JaxGenConfig
from superconductor_vae_tpu.generation import generate_with_kv_cache as jax_generate
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.ops.physics_z_loss import init_magpie_proj as jax_init_proj
from superconductor_vae_tpu.ops.round_trip import round_trip_loss as jax_round_trip
from superconductor_vae_tpu.ops.round_trip import tokens_to_composition as jax_to_comp
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import train_step as jts
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.generation.generate import sequence_mask
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.ops.round_trip import round_trip_loss, tokens_to_composition
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    TrainConfig, build_luts, default_dyn, make_epoch_runner, make_train_step,
    stoich_conditioning)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_train_step import (
    MET_TOL, _batches, _leaves, _port_moments, _port_params, _port_state, _to_torch,
    check_moments_and_updates)
from torch_port_common import batch, jax_config, param_trees, port_models, set_param_tree

CFG = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0)
GROUPS = ('enc', 'dec', 'pz', 'set')


def _luts_pair(max_len):
    return (jts.build_luts(jax_tokenizer(max_len=max_len)),
            build_luts(default_tokenizer(max_len=max_len), 'cpu'))


def test_tokens_to_composition_is_bit_equal_to_jax():
    tok = default_tokenizer(max_len=CFG.max_len)
    formulas = ['NbN', 'Fe2Se2', 'Fe0.5Se0.5', 'NaCl', 'MgB2', 'YBa2Cu3O7', 'La2CuO4',
                'Ba0.6K0.4Fe2As2', 'CaC6', 'Nb3Sn', 'H3S', 'Bi2Sr2CaCu2O8']
    enc = tok.encode_batch(formulas)[:, 1:]                     # a rollout has no BOS
    rng = np.random.default_rng(0)
    streams = np.concatenate([enc, rng.integers(0, tok.vocab_size, (12, enc.shape[1]))])
    tokens = torch.as_tensor(streams).long()
    mask = sequence_mask(tokens)
    jluts, luts = _luts_pair(CFG.max_len)
    want = jax_to_comp(jnp.asarray(streams, jnp.int32), jnp.asarray(mask.numpy()),
                       jluts['token_to_z'], jluts['token_value_table'])
    got = tokens_to_composition(tokens, mask, luts['token_to_z'], luts['token_value_table'])
    # the tie cases hold what they are meant to: equal amounts of two elements
    frac = got[1].numpy()
    assert (frac[:3, :2] == 0.5).all() and (frac[:3, 2:] == 0).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope='module')
def round_trip_runs():
    """The round trip over 8 rows in both packages, from the same numpy
    parameters; the encoder forward in eval mode feeds it as in the step."""
    trees = param_trees(CFG, seed=3)
    data = batch(CFG, 8, seed=4)
    jcfg = jax_config(CFG)
    jenc, jdec = JaxEncoder(jcfg), JaxDecoder(jcfg)
    jluts, luts = _luts_pair(CFG.max_len)

    def jax_fn(enc_p, dec_p):
        out = jenc.apply(enc_p, data['element_indices'], data['element_fractions'],
                         data['element_mask'], data['magpie'], data['tc'])
        hv = jenc.apply(enc_p, out, method=JaxEncoder.heads_pred_for_decoder)
        stoich = jts.stoich_conditioning({k: jnp.asarray(v) for k, v in data.items()})
        rt = jax_round_trip(jenc, enc_p, jdec, dec_p, out['z'], stoich, hv,
                            out['magpie_pred'], out['tc_pred'], jluts, jax.random.PRNGKey(0),
                            8, max_len=CFG.max_len)
        return rt['round_trip_loss'], rt
    (_, want), (g_enc, g_dec) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(*trees)

    enc, dec = port_models(CFG, trees)
    t = {k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v)
         for k, v in data.items()}
    out = enc(t['element_indices'], t['element_fractions'], t['element_mask'], t['magpie'],
              t['tc'])
    got = round_trip_loss(enc, dec, out['z'], stoich_conditioning(t),
                          enc.heads_pred_for_decoder(out), out['magpie_pred'], out['tc_pred'],
                          luts, 8, max_len=CFG.max_len)
    got['round_trip_loss'].backward()
    # JAX's rollout on its own, for the tokens
    gen = jax_generate(jdec, trees[1], np.asarray(out['z'].detach()),
                       np.asarray(stoich_conditioning(t)),
                       np.asarray(enc.heads_pred_for_decoder(out).detach()),
                       jax.random.PRNGKey(0), JaxGenConfig(max_len=CFG.max_len, temperature=0.0))
    return dict(want=want, g_enc=_leaves(g_enc), g_dec=jax.tree.leaves(g_dec), got=got,
                enc=enc, dec=dec, jax_tokens=np.asarray(gen['tokens']))


def test_round_trip_loss_matches_jax(round_trip_runs):
    r = round_trip_runs
    got, want = r['got'], r['want']
    assert (got['tokens'].numpy() == r['jax_tokens']).all()
    for k in ('round_trip_loss', 'z_mse', 'tc_mse'):
        np.testing.assert_allclose(got[k].item(), np.asarray(want[k]), **MET_TOL, err_msg=k)
    assert want['z_mse'] > 0 and want['tc_mse'] > 0


def test_round_trip_gradients_match_jax(round_trip_runs):
    r = round_trip_runs
    want = r['g_enc']
    scale = max(np.abs(w).max() for w in want.values())
    got = {n: p.grad for n, p in r['enc'].named_parameters()}
    reached = 0
    for name, w in want.items():
        g = got[name].numpy() if got[name] is not None else np.zeros_like(w)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * scale, err_msg=name)
        reached += got[name] is not None
    assert reached > 0.5 * len(want)
    # the decoder: exactly zero in JAX, and no gradient reaches it in the port
    assert all(not np.asarray(x).any() for x in r['g_dec'])
    assert all(p.grad is None for p in r['dec'].parameters())


@pytest.fixture(scope='module')
def default_steps():
    """Two chained JAX steps at TrainConfig()'s defaults (states S0 -> S1 ->
    S2); the port's step i from S(i-1), once through make_train_step and
    once through make_epoch_runner over a one-batch epoch."""
    enc_np, dec_np = param_trees(CFG, seed=0)
    pz_np = jax.tree.map(np.asarray, jax_init_proj(jax.random.PRNGKey(3), CFG.magpie_dim))
    jtc, tc = JaxTrainConfig(), TrainConfig()
    set_np = set_param_tree(CFG.latent_dim, seed=5, d_model=tc.hungarian_d_model,
                            num_layers=tc.hungarian_num_layers,
                            dim_feedforward=tc.hungarian_dim_feedforward,
                            n_slots=CFG.max_elements, n_z_tokens=tc.hungarian_n_z_tokens)
    batches = _batches(CFG)
    jluts, luts = _luts_pair(CFG.max_len)
    tx_enc, tx_dec = jts.make_optimizer(jtc), jts.make_optimizer(jtc)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), enc_params=enc_np, dec_params=dec_np,
        enc_opt=tx_enc.init(enc_np), dec_opt=tx_dec.init(dec_np),
        set_params=set_np, set_opt=tx_dec.init(set_np),
        pz_params=pz_np, pz_opt=tx_enc.init(pz_np))
    real_make = jts.make_set_decoder
    with pytest.MonkeyPatch.context() as mp:
        # the flax set decoder's own dropout (0.1) off, as every model's here
        mp.setattr(jts, 'make_set_decoder', lambda *a, **k: real_make(*a, **k).clone(
            dropout=0.0))
        step = jts.make_train_step(JaxEncoder(jax_config(CFG)), JaxDecoder(jax_config(CFG)),
                                   jtc, tx_enc, tx_dec, jluts, donate=False)
        dyn = dict(jts.default_dyn(jtc), physz_w=jnp.asarray(1.0, jnp.float32))
        jax_states, jax_metrics = [jax.tree.map(np.asarray, state)], []
        for bt in batches:
            state, metrics = step(state, bt, jax.random.PRNGKey(0), dyn)
            jax_states.append(jax.tree.map(np.asarray, state))
            jax_metrics.append(jax.tree.map(np.asarray, metrics))

    pdyn = dict(default_dyn(tc), physz_w=1.0)
    pstep = make_train_step(tc, luts)
    run = make_epoch_runner(tc, luts)
    data = {k: torch.cat([_to_torch(b)[k] for b in batches]) for k in batches[0]}
    n = len(batches[0]['tc'])
    port = {'step': [], 'runner': []}
    for i, bt in enumerate(batches):
        for path in port:
            pstate = _port_state(jax_states[i], CFG, tc)
            assert len(pstate.groups()) == 4
            before = _port_params(pstate)
            if path == 'step':
                pstate, metrics = pstep(pstate, _to_torch(bt), 0, pdyn)
            else:
                pstate, metrics = run(pstate, data, np.arange(i * n, (i + 1) * n)[None], 0,
                                      pdyn)
            assert pstate.step == i + 1
            port[path].append((before, _port_params(pstate), _port_moments(pstate),
                               {k: v.item() for k, v in metrics.items()}))
    return dict(jax_states=jax_states, jax_metrics=jax_metrics, port=port,
                lr=tc.learning_rate, wd=tc.weight_decay)


@pytest.mark.parametrize('path', ['step', 'runner'])
@pytest.mark.parametrize('i', [0, 1])
def test_default_step_metrics_match_jax(default_steps, path, i):
    want = default_steps['jax_metrics'][i]
    got = default_steps['port'][path][i][3]
    assert set(got) == set(want)
    for key in ('a5_z_mse', 'a5_tc_mse', 'hungarian_loss', 'set_element_accuracy',
                'set_exact'):
        assert key in want, key
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **MET_TOL, err_msg=key)


@pytest.mark.parametrize('path', ['step', 'runner'])
@pytest.mark.parametrize('i', [0, 1])
def test_default_step_moments_and_params_match_jax(default_steps, path, i):
    before, params, moments, _ = default_steps['port'][path][i]
    check_moments_and_updates(before, params, moments, default_steps['jax_states'][i],
                              default_steps['jax_states'][i + 1], default_steps['lr'],
                              default_steps['wd'], i + 1, names=GROUPS)
