"""The RL slice of the port against the JAX package: the V14 reward, the
constraint rewards, the batch novelty bonus, the TF re-score, SCST and
RLOO with their gradients, one RL train step, and the RL parts of the host
schedulers; and the decode step's independence of the decoder's mode.

Widths: ``tiny_test_config`` with a 512-wide latent (the physics-Z loss of
the train step reads latent coordinates up to 512), dropout 0.  Weights
are numpy trees from a seed (``torch_port_common``), with the stop head
turned so that sampled rollouts end at varied steps.

Sampling streams cannot match across the two frameworks, so every
comparison that samples records the port's rollout and feeds it to the JAX
package through ``superconductor_vae_tpu.ops.rl._rollout`` (pytest's
monkeypatch; JAX looks the function up while tracing).

Tolerances: rewards are exact up to float32 rounding (1e-6 relative);
losses and scalar metrics 1e-5 relative (one RLOO loss that cancels far
below its terms: 1e-5 of the sum of its |terms|); log-probs 2e-5 (float32 logits
through a softmax over 4,752 tokens); gradients 1e-4 of the largest
element of their tree.  The train step is held to the tolerances of
tests/test_torch_port_train_step.py.
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
from superconductor_vae_tpu.ops import constraints as jcon
from superconductor_vae_tpu.ops import reward as jrew
from superconductor_vae_tpu.ops import rl as jrl
from superconductor_vae_tpu.ops.physics_z_loss import init_magpie_proj as jax_init_proj
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import schedulers as jsched
from superconductor_vae_tpu.training import train_step as jts
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from superconductor_vae_tpu_torch.generation import sequence_mask
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.ops import constraints as pcon
from superconductor_vae_tpu_torch.ops import reward as prew
from superconductor_vae_tpu_torch.ops import rl as prl
from superconductor_vae_tpu_torch.tokenizer import (
    EOS_ID, ELEMENT_TOKEN_START, FRACTION_TOKEN_START, INTEGER_TOKEN_START,
    default_tokenizer)
from superconductor_vae_tpu_torch.training import (
    EntropyManager, PerPositionEntropyWeighter, RLController, TrainConfig, TrainState,
    build_luts, default_dyn, make_train_step)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_train_step import (
    TCFG, _batches, _port_moments, _port_params, _port_state, _to_torch,
    check_moments_and_updates)
from torch_port_common import jax_config, param_trees, port_models

CFG = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0)
B = 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LP_TOL = dict(rtol=1e-5, atol=2e-5)
TOK = default_tokenizer(max_len=CFG.max_len)
LUTS = build_luts(TOK, 'cpu')
JLUTS = jts.build_luts(jax_tokenizer(max_len=CFG.max_len))
SYMBOLS = {s: i + 1 for i, s in enumerate(
    'H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co Ni Cu Zn Ga '
    'Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb Te I Xe Cs Ba La Ce Pr Nd '
    'Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re Os Ir Pt Au Hg Tl Pb Bi'.split())}


def _trees(cfg=CFG):
    """Weights whose rollouts end at varied steps: the stop head turned so
    that its probability rises along a rollout, the type head kept from
    predicting EOS (values chosen by trying them at these widths)."""
    trees = param_trees(cfg, seed=1)
    dec = trees[1]['params']
    dec['stop_d2']['kernel'] *= -1
    dec['stop_d2']['bias'][:] = 1.4
    dec['type_d3']['bias'][:] = [0.0, 0.0, 0.0, -3.0, -3.0]
    return trees


def _jax_rl_config(cfg: prl.RLConfig) -> jrl.RLConfig:
    """The JAX RLConfig of the same fields (reward and constraint configs
    at their defaults, which agree)."""
    return jrl.RLConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                           if f.name not in ('reward', 'constraints')})


def _stream(*items, t=CFG.max_len - 1):
    """A token stream from element symbols, integer subscripts (int) and
    fraction amounts (float), then EOS and padding to ``t``."""
    ids = []
    for x in items:
        if isinstance(x, str):
            ids.append(ELEMENT_TOKEN_START + SYMBOLS[x] - 1)
        elif isinstance(x, int):
            ids.append(INTEGER_TOKEN_START + x - 1)
        else:
            hit = np.nonzero(np.isclose(TOK.token_value_table, x)
                             & (np.arange(TOK.vocab_size) >= FRACTION_TOKEN_START))[0]
            ids.append(int(hit[0]))
    ids.append(EOS_ID)
    return ids + [0] * (t - len(ids))


def _inputs(b=B, seed=5):
    """Latent, stoichiometry conditioning and head vector from a seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, CFG.latent_dim)).astype(np.float32),
            rng.standard_normal((b, CFG.stoich_input_dim)).astype(np.float32),
            rng.standard_normal((b, CFG.heads_input_dim)).astype(np.float32))


# -- reward --------------------------------------------------------------------

_TARGET = ['Y', 'Ba', 2, 'Cu', 3, 'O', 6.2]


def _reward_case(case):
    """(sampled, targets) [N, 15] int arrays for one branch of the reward,
    and the reward each row must get (None: no closed form)."""
    if case == 'random':
        rng = np.random.default_rng(0)
        tgt = np.array([_stream(*_TARGET)] * 6)
        smp = tgt.copy()
        flip = rng.random(smp.shape) < 0.3
        smp[flip] = rng.integers(0, 400, flip.sum())
        smp[1, 3] = EOS_ID
        return smp, tgt, None
    tgt = np.array([_stream(*_TARGET)] * 2)
    if case == 'exact':
        smp = tgt.copy()
        return smp, tgt, [100.0, 100.0]
    if case == 'length_only':       # the whole target, then 1 and 3 extra tokens
        smp = np.array([_stream(*_TARGET, 'O'), _stream(*_TARGET, 'O', 2, 'F')])
        return smp, tgt, [45.0, 35.0]
    if case == 'too_short':         # a perfect prefix, END 2 and 6 tokens early
        # under the sampled stream's mask the target's END lies past the
        # mask, so its end is the mask's length: one token missing
        smp = np.array([_stream(*_TARGET[:-2]), _stream(*_TARGET[:2])])
        return smp, tgt, [45.0, 45.0]
    assert case == 'continuous'     # element, integer and fraction errors
    smp = np.array([_stream('Y', 'Sr', 2, 'Cu', 3, 'O', 6.2),
                    _stream('Y', 'Ba', 2, 'Cu', 4, 'O', 0.5)])
    return smp, tgt, None


@pytest.mark.parametrize('fractions', [True, False], ids=['fraction_values', 'no_values'])
@pytest.mark.parametrize('case', ['random', 'exact', 'length_only', 'too_short',
                                  'continuous'])
def test_compute_reward_matches_jax(case, fractions):
    smp, tgt, want_closed = _reward_case(case)
    mask = sequence_mask(torch.as_tensor(smp))
    got = prew.compute_reward(torch.as_tensor(smp), torch.as_tensor(tgt), mask,
                              fraction_values=LUTS['fraction_values'] if fractions else None)
    want = jrew.compute_reward(jnp.asarray(smp, jnp.int32), jnp.asarray(tgt, jnp.int32),
                               jnp.asarray(mask.numpy()),
                               fraction_values=JLUTS['fraction_values'] if fractions else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if want_closed is not None:
        np.testing.assert_array_equal(got.numpy(), want_closed)
    if case == 'continuous':
        assert (got.numpy() < 100.0).all() and len(set(got.tolist())) == 2


# -- constraint rewards ----------------------------------------------------------

# (stream, family id, penalty under a confident family prediction)
_RULES = {
    'A1_duplicate': (['Cu', 'O', 'Cu', 2], 0, -50.0),
    'A4_reducible': (['Ba', 2, 'O', 4], 0, -10.0),
    'A7_F_Tl': (['F', 'Tl'], 0, -30.0),
    'A7_magnetic_Cu': (['Cu', 'Fe'], 0, -30.0),
    'B1_ybco_oxygen': (['Y', 'Ba', 2, 'Cu', 3, 'O', 6], 2, -40.0),
    'B2_lsco_sr': (['La', 1.7, 'Sr', 0.3, 'Cu', 'O', 4], 3, -40.0),
    'B3_bscco_ca_cu': (['Bi', 2, 'Sr', 2, 'Ca', 3, 'Cu', 2, 'O', 9], 4, -40.0),
    'B4_hg_vanadium': (['Hg', 'V'], 6, -30.0),
    'B5_tl_poisons': (['Tl', 'V', 'Li', 'Mn'], 5, -90.0),
    'B6_iron_oxygen': (['La', 'Fe', 'As', 'O', 0.5], 8, -30.0),
    'B7_mgb2_poisons': (['Mg', 'B', 2, 'C', 0.5, 'Al', 'Co'], 10, -90.0),
    'B8_a15_ratio': (['Nb', 3, 'Al', 2], 1, -30.0),
    'clean': (['Mg', 'B', 2], 10, 0.0),
}


@pytest.mark.parametrize('gate', ['confident', 'unsure', 'none'])
@pytest.mark.parametrize('rule', sorted(_RULES))
def test_constraint_rewards_match_jax(rule, gate):
    items, fam, penalty = _RULES[rule]
    smp = np.array([_stream(*items)] * 2)
    mask = sequence_mask(torch.as_tensor(smp))
    fp = None
    if gate != 'none':
        # the family at 0.9 (row 0) or 0.7 (row 1) under the confident gate,
        # 0.7 on both rows otherwise; the rest spread evenly
        top = [0.9, 0.7] if gate == 'confident' else [0.7, 0.7]
        fp = np.array([[(1 - p) / 13] * 14 for p in top], np.float32)
        fp[[0, 1], fam] = top
    got = pcon.constraint_rewards(torch.as_tensor(smp), mask, LUTS['token_to_z'],
                                  LUTS['token_value_table'],
                                  family_predictions=None if fp is None else torch.as_tensor(fp))
    want = jcon.constraint_rewards(jnp.asarray(smp, jnp.int32), jnp.asarray(mask.numpy()),
                                   JLUTS['token_to_z'], JLUTS['token_value_table'],
                                   family_predictions=None if fp is None else jnp.asarray(fp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    family_rule = rule.startswith('B')
    confident_row = penalty if (gate == 'confident' or not family_rule) else 0.0
    other_row = 0.0 if family_rule else penalty
    np.testing.assert_array_equal(got.numpy(), [confident_row, other_row])


@pytest.mark.parametrize('k', [2, 5])
def test_batch_novelty_bonus_matches_jax(k):
    rng = np.random.default_rng(k)
    smp = rng.integers(5, 40, (7, 10))
    smp[1] = smp[0]                                   # a twin
    smp[3, 4] = EOS_ID
    mask = sequence_mask(torch.as_tensor(smp))
    got = prew.batch_novelty_bonus(torch.as_tensor(smp), mask, TOK.vocab_size,
                                   k_nearest=k, weight=0.3)
    want = jrew.batch_novelty_bonus(jnp.asarray(smp, jnp.int32), jnp.asarray(mask.numpy()),
                                    TOK.vocab_size, k_nearest=k, weight=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert (got.numpy() >= 0).all() and (got.numpy() <= 0.3).all()


@pytest.mark.parametrize('t', [3, 5, 8])
@pytest.mark.parametrize('dtype', [np.int64, np.float32])
def test_pad_to_matches_jax(t, dtype):
    x = np.arange(10, dtype=dtype).reshape(2, 5) + 1
    got = prl._pad_to(torch.as_tensor(x), t, 0)
    want = jrl._pad_to(jnp.asarray(x), t, 0)
    assert got.dtype == torch.as_tensor(x).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- rollouts and the TF re-score --------------------------------------------------

@pytest.fixture(scope='module')
def models():
    """The port's decoder (and encoder) and the JAX decoder's params, from
    the same trees."""
    trees = _trees()
    _, dec = port_models(CFG, trees)
    return dict(trees=trees, dec=dec, jdec=JaxDecoder(jax_config(CFG)),
                jparams=trees[1])


@pytest.mark.parametrize('type_masking, site_dup', [(True, 0.0), (False, 0.0), (True, 0.5)])
def test_rescore_matches_jax_and_the_rollout(models, type_masking, site_dup):
    """The port's re-score of its own sampled rollout against its rollout's
    log-probs (2e-4, the JAX test's tolerance) and against the JAX
    package's re-score of the same tokens."""
    cfg = prl.RLConfig(max_len=CFG.max_len, use_type_masking=type_masking,
                       site_dup_threshold=site_dup, early_exit=False)
    z, st, hv = (torch.as_tensor(x) for x in _inputs())
    out = prl._rollout(models['dec'], z, st, hv, torch.Generator().manual_seed(7), cfg,
                       LUTS, greedy=False)
    lengths = out['mask'].sum(dim=1)
    assert lengths.min() < lengths.max()                      # rows end at varied steps
    with torch.no_grad():
        got = prl.rescore_log_probs(models['dec'], z, st, hv, out['tokens'], cfg, LUTS)
    np.testing.assert_allclose(got.numpy(), out['log_probs'].numpy(), rtol=2e-4, atol=2e-4)
    want = jrl.rescore_log_probs(models['jdec'], models['jparams'], *map(jnp.asarray, _inputs()),
                                 jnp.asarray(out['tokens'].numpy(), jnp.int32),
                                 _jax_rl_config(cfg), JLUTS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LP_TOL)


def test_scst_greedy_half_matches_jax_greedy(models):
    """The greedy half of the fused [2B] SCST rollout against the JAX
    package's greedy rollout of the same rows: token-identical up to each
    row's EOS."""
    cfg = prl.RLConfig(max_len=CFG.max_len)
    z, st, hv = (torch.as_tensor(x) for x in _inputs())
    two = lambda x: torch.cat([x, x])
    gmask = torch.arange(2 * B) < B
    with torch.no_grad():
        memory = models['dec'].build_memory(z, st, hv)
    both = prl._rollout(models['dec'], two(z), two(st), two(hv),
                        torch.Generator().manual_seed(3), cfg, LUTS, greedy=False,
                        memory=two(memory), greedy_mask=gmask)
    gcfg = JaxGenConfig(**dataclasses.asdict(prl._gen_cfg(cfg, greedy=True)))
    want = jax_generate(models['jdec'], models['jparams'], *map(jnp.asarray, _inputs()),
                        jax.random.PRNGKey(0), gcfg, type_masks=JLUTS['type_masks'])
    want_tok = np.asarray(want['tokens'])
    want_mask = np.asarray(want['mask']).astype(bool)
    got_tok = both['tokens'][:B].numpy()
    np.testing.assert_array_equal(both['mask'][:B].numpy().astype(bool), want_mask)
    np.testing.assert_array_equal(np.where(want_mask, got_tok, 0), np.where(want_mask, want_tok, 0))
    np.testing.assert_array_equal(both['log_probs'][:B].numpy(), 0.0)
    assert (both['log_probs'][B:].numpy() < 0).any()


# -- SCST and RLOO -------------------------------------------------------------------

def _targets():
    return TOK.encode_batch(['YBa2Cu3O7', 'MgB2', 'Nb3Sn', 'LaFeAsO'])[:, 1:].astype(np.int64)


def _family_predictions():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((B, 14)).astype(np.float32)
    logits[[0, 2], [2, 10]] += 6.0                    # two rows over the 0.8 gate
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _rloo_terms(dec, z, st_np, hv, tgt, rollout, cfg, kw):
    """The sum of |terms| of the port's RLOO loss, sum over K of the mean
    over B of |(r - baseline) x sequence log-prob x sc_weight|, recomputed
    as ``rloo_loss`` computes them from the same rollout."""
    k = cfg.n_samples_rloo
    t = tgt.shape[1]
    rep = lambda x: torch.as_tensor(x).detach().repeat(k, 1)
    tokens, mask = prl._pad_to(rollout['tokens'], t, 0), prl._pad_to(rollout['mask'], t, 0.0)
    pos_w = kw.get('position_entropy_w')
    with torch.no_grad():
        lp = prl.rescore_log_probs(dec, rep(z), rep(st_np), rep(hv), tokens, cfg, LUTS,
                                   temperature=kw['temperature'])
        r = prl._total_reward(tokens, rep(tgt), mask, cfg, LUTS, rep(kw['family_predictions'])) \
            + kw['entropy_weight'] * prl._seq_entropy(
                prl._pad_to(rollout['entropy'], t, 0.0), mask,
                None if pos_w is None else torch.as_tensor(pos_w))
        r = r.reshape(k, -1)
        adv = r - (r.sum(dim=0, keepdim=True) - r) / (k - 1)
        terms = (adv * (lp * mask).sum(dim=1).reshape(k, -1)).abs()
        if 'sc_weight' in kw:
            terms = terms * torch.as_tensor(kw['sc_weight'])[None, :]
    return terms.mean(dim=1).sum().item()


def _loss_pair(models, method, weighted):
    """(port, JAX) results of one SCST or RLOO loss on the same weights and
    the same rollout: loss, mean reward, entropy, reward_var and the
    gradients w.r.t. the decoder's parameters, z and heads_vec."""
    cfg = prl.RLConfig(max_len=CFG.max_len, method=method, n_samples_rloo=3,
                       novelty_weight=0.1)
    kw = dict(family_predictions=_family_predictions(), temperature=1.1)
    if weighted:
        kw.update(sc_weight=np.array([1, 0, 1, 1], np.float32),
                  position_entropy_w=np.linspace(2.0, 0.5, CFG.max_len - 1).astype(np.float32))
    if method == 'rloo':
        kw['entropy_weight'] = 0.3
    z_np, st_np, hv_np = _inputs()
    tgt = _targets()

    # the port, recording its rollout
    _, dec = port_models(CFG, models['trees'])
    z, hv = torch.tensor(z_np, requires_grad=True), torch.tensor(hv_np, requires_grad=True)
    recorded = []
    original = prl._rollout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prl, '_rollout', lambda *a, **k: recorded.append(original(*a, **k))
                   or recorded[-1])
        fn = prl.scst_loss if method == 'scst' else prl.rloo_loss
        loss, reward, ent, extras = fn(
            dec, z, torch.as_tensor(st_np), hv, torch.as_tensor(tgt),
            torch.Generator().manual_seed(11), cfg, LUTS,
            **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
    loss.backward()
    assert len(recorded) == 1
    port = dict(values=[x.item() for x in (loss, reward, ent, extras['reward_var'])],
                terms=_rloo_terms(dec, z, st_np, hv, tgt, recorded[0], cfg, kw)
                if method == 'rloo' else None,
                dec={n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                     for n, p in dec.named_parameters()},
                z=z.grad.numpy(), hv=hv.grad.numpy(), rollout=recorded[0])

    # JAX, fed the same rollout
    rollout = {k: jnp.asarray(v.numpy().astype(np.int32) if k == 'tokens' else v.numpy())
               for k, v in recorded[0].items() if k != 'margin'}
    jfn = jrl.scst_loss if method == 'scst' else jrl.rloo_loss
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}

    def f(params, zz, hh):
        loss, reward, ent, extras = jfn(models['jdec'], params, zz, jnp.asarray(st_np), hh,
                                        jnp.asarray(tgt, jnp.int32), jax.random.PRNGKey(0),
                                        _jax_rl_config(cfg), JLUTS, **jkw)
        return loss, (reward, ent, extras['reward_var'])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrl, '_rollout', lambda *a, **k: rollout)
        (jloss, aux), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
            models['jparams'], jnp.asarray(z_np), jnp.asarray(hv_np))
    want = dict(values=[float(jloss)] + [float(x) for x in aux],
                dec={k: v.numpy() for k, v in state_dict_from_flax(
                    jax.tree.map(np.asarray, grads[0])).items()},
                z=np.asarray(grads[1]), hv=np.asarray(grads[2]))
    return port, want


def _grads_close(got, want, what):
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 0, what
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale,
                                   err_msg=f'{what}: {k}')


@pytest.mark.parametrize('weighted', [False, True], ids=['plain', 'sc_and_position_weights'])
@pytest.mark.parametrize('method', ['scst', 'rloo'])
def test_rl_loss_and_gradients_match_jax(models, method, weighted):
    port, want = _loss_pair(models, method, weighted)
    rows = port['rollout']['tokens'].shape[0]
    assert rows == (2 * B if method == 'scst' else 3 * B)
    np.testing.assert_allclose(port['values'][1:], want['values'][1:], **LOSS_TOL)
    if method == 'rloo' and weighted:
        # This loss cancels: its leave-one-out advantages sum to 0 over a
        # row's K samples, and here its terms, |terms| summing to about
        # 2e3, add up to -1.36.  The two programs differ by float32
        # rounding at the terms' scale (6.1e-5 absolute, as in the plain
        # RLOO case's 4.6e-5 on -114), so the loss is held to LOSS_TOL's
        # relative tolerance of the sum of its |terms|.
        assert port['terms'] > 100 * abs(port['values'][0])
        assert abs(port['values'][0] - want['values'][0]) <= LOSS_TOL['rtol'] * port['terms']
    else:
        if method == 'rloo':
            assert port['terms'] < 100 * abs(port['values'][0])
        np.testing.assert_allclose(port['values'][0], want['values'][0], **LOSS_TOL)
    assert port['values'][0] != 0.0 and port['values'][3] > 0.0
    _grads_close(port['dec'], want['dec'], 'decoder gradients')
    _grads_close({'z': port['z']}, {'z': want['z']}, 'z gradient')
    _grads_close({'hv': port['hv']}, {'hv': want['hv']}, 'heads_vec gradient')


# -- one RL train step ------------------------------------------------------------

@pytest.fixture(scope='module')
def rl_step():
    """One SCST train step of the port and of the JAX package (jitted once)
    from the same state, on 4 CSV rows, with rl_w 1 and physz_w 1, the
    JAX step fed the port's rollout."""
    enc_np, dec_np = _trees()
    pz_np = jax.tree.map(np.asarray, jax_init_proj(jax.random.PRNGKey(3), CFG.magpie_dim))
    bt = _batches(CFG)[1]
    rl_kw = dict(max_len=CFG.max_len)
    jtc = JaxTrainConfig(**TCFG, rl=jrl.RLConfig(**rl_kw))
    tx_enc, tx_dec = jts.make_optimizer(jtc), jts.make_optimizer(jtc)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), enc_params=enc_np, dec_params=dec_np,
        enc_opt=tx_enc.init(enc_np), dec_opt=tx_dec.init(dec_np),
        pz_params=pz_np, pz_opt=tx_enc.init(pz_np))
    state0 = jax.tree.map(np.asarray, state)

    tc = TrainConfig(**TCFG, rl=prl.RLConfig(**rl_kw))
    pdyn = dict(default_dyn(tc), physz_w=1.0, rl_w=1.0)
    pstate = _port_state(state0, CFG, tc)
    before = _port_params(pstate)
    recorded = []
    original = prl._rollout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prl, '_rollout', lambda *a, **k: recorded.append(original(*a, **k))
                   or recorded[-1])
        pstate, metrics = make_train_step(tc, LUTS, rl_enabled=True)(
            pstate, _to_torch(bt), 0, pdyn)
    assert len(recorded) == 1 and pstate.step == 1

    rollout = {k: jnp.asarray(v.numpy().astype(np.int32) if k == 'tokens' else v.numpy())
               for k, v in recorded[0].items()}
    jdyn = dict(jts.default_dyn(jtc), physz_w=jnp.asarray(1.0), rl_w=jnp.asarray(1.0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrl, '_rollout', lambda *a, **k: rollout)
        step = jts.make_train_step(JaxEncoder(jax_config(CFG)), JaxDecoder(jax_config(CFG)),
                                   jtc, tx_enc, tx_dec, JLUTS, rl_enabled=True, donate=False)
        state1, jmetrics = step(state, bt, jax.random.PRNGKey(0), jdyn)
    return dict(port=(before, _port_params(pstate), _port_moments(pstate),
                      {k: v.item() for k, v in metrics.items()}),
                jax_states=(state0, jax.tree.map(np.asarray, state1)),
                jax_metrics={k: float(v) for k, v in jmetrics.items()},
                lr=tc.learning_rate, wd=tc.weight_decay, rollout=recorded[0])


def test_rl_step_metrics_match_jax(rl_step):
    got, want = rl_step['port'][3], rl_step['jax_metrics']
    assert set(got) == set(want)
    assert {'reinforce_loss', 'mean_reward', 'reward_var'} <= set(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    for key in ('reinforce_loss', 'mean_reward', 'reward_var'):
        np.testing.assert_allclose(got[key], want[key], **LOSS_TOL, err_msg=key)
    assert got['reinforce_loss'] != 0.0
    assert rl_step['rollout']['tokens'].shape == (2 * B, CFG.max_len - 1)


def test_rl_step_moments_and_params_match_jax(rl_step):
    before, params, moments, _ = rl_step['port']
    check_moments_and_updates(before, params, moments, *rl_step['jax_states'],
                              rl_step['lr'], rl_step['wd'], 1)


def test_rl_step_rollouts_follow_seed_and_step():
    """The rollouts' generator is seeded from (seed, step): the same pair
    samples the same rollout, another seed another one."""
    tc = TrainConfig(**TCFG, rl=prl.RLConfig(max_len=CFG.max_len))
    bt = _to_torch(_batches(CFG)[1])
    original = prl._rollout
    tokens = []
    for seed in (5, 5, 6):
        enc, dec = port_models(CFG, _trees())
        state = TrainState.from_modules(enc, dec, tc)
        recorded = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(prl, '_rollout', lambda *a, **k: recorded.append(original(*a, **k))
                       or recorded[-1])
            make_train_step(tc, LUTS, rl_enabled=True)(
                state, bt, seed, dict(default_dyn(tc), rl_w=1.0))
        tokens.append(recorded[0]['tokens'][B:])
    assert torch.equal(tokens[0], tokens[1]) and not torch.equal(tokens[0], tokens[2])


# -- decode step and re-score are deterministic in train mode -------------------------

def test_decode_step_ignores_train_mode():
    """With dropout on, the decode step of a decoder in train mode gives the
    heads of the same decoder in eval mode: a rollout inside a train step
    samples from the heads without dropout, as the JAX decode step does."""
    cfg = dataclasses.replace(CFG, dropout=0.5)
    _, dec = port_models(cfg, _trees(cfg))
    rng = np.random.default_rng(0)
    z, st, hv = (torch.as_tensor(x) for x in _inputs())
    token = torch.as_tensor(rng.integers(5, 200, B))
    heads = []
    for mode in ('train', 'eval'):
        getattr(dec, mode)()
        torch.manual_seed(0)
        with torch.no_grad():
            mkv = dec.memory_kv(dec.build_memory(z, st, hv))
            kc, vc = dec.init_cache(B)
            h0, kc, vc = dec.decode_step(torch.full((B,), 1), 0, kc, vc, mkv)
            h1, _, _ = dec.decode_step(token, 1, kc, vc, mkv)
        heads.append((h0, h1))
    for a, b in zip(*heads):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_rescore_ignores_train_mode_and_keeps_it():
    cfg = dataclasses.replace(CFG, dropout=0.5)
    _, dec = port_models(cfg, _trees(cfg))
    z, st, hv = (torch.as_tensor(x) for x in _inputs())
    tokens = torch.as_tensor(_targets())
    rl_cfg = prl.RLConfig(max_len=CFG.max_len)
    out = []
    for mode in ('train', 'eval'):
        getattr(dec, mode)()
        out.append(prl.rescore_log_probs(dec, z, st, hv, tokens, rl_cfg, LUTS))
        assert dec.training == (mode == 'train')
    assert torch.equal(out[0], out[1])
    assert out[0].requires_grad


# -- the schedulers' RL parts ---------------------------------------------------------

def test_rl_controller_matches_jax():
    """RL auto-reactivation on a plateau, warmup ramp, auto-scale, the
    safety guard's halving and the duty cycle, epoch by epoch, and a state
    handed from one side to the other mid-run."""
    kw = dict(rl_weight=0.0, rl_reactivation_window=3, rl_warmup_epochs=4,
              rl_safety_check_interval=2, rl_min_ar_exact=0.3, rl_epoch_interval=2,
              rl_temperature_decay_epochs=6)
    port, ref = RLController(TrainConfig(**kw)), jsched.RLController(JaxTrainConfig(**kw))
    rng = np.random.default_rng(0)
    tf = np.concatenate([np.linspace(0.5, 0.85, 8), np.full(6, 0.851),
                         [0.80, 0.79, 0.83, 0.84], np.linspace(0.84, 0.9, 10)])
    weights = []
    for epoch, tf_exact in enumerate(tf):
        raw = float(rng.uniform(0.5, 5.0)) if epoch % 3 else None
        args = (epoch, float(tf_exact), float(tf_exact) - 0.2, raw)
        w = port.epoch_update(*args)
        assert w == ref.epoch_update(*args), epoch
        assert port.temperature(epoch) == ref.temperature(epoch)
        assert port.state_dict() == ref.state_dict()
        weights.append(w)
        if epoch == 15:
            port = RLController(TrainConfig(**kw))
            port.load_state_dict(ref.state_dict())
    assert port.active and port.activation_epoch is not None
    assert len(set(weights)) > 4                   # off, ramp, auto-scale, halving


@pytest.mark.parametrize('strategy', ['causal', 'adaptive', 'cyclical', 'composite',
                                      'constant'])
def test_entropy_manager_matches_jax(strategy):
    kw = dict(entropy_strategy=strategy, entropy_plateau_window=4,
              entropy_variance_threshold=20.0)
    port, ref = EntropyManager(TrainConfig(**kw)), jsched.EntropyManager(JaxTrainConfig(**kw))
    rng = np.random.default_rng(1)
    for i in range(24):
        reward = 10.0 + (i if i < 8 else 8.0)
        entropy = 0.6 * 0.85 ** i
        var = float(rng.uniform(5.0, 60.0)) if i % 5 else None
        assert port.update(reward, entropy, var) == ref.update(reward, entropy, var), i
        assert port.state_dict() == ref.state_dict()
        assert port.temperature_scale == ref.temperature_scale
    half = EntropyManager(TrainConfig(**kw))
    half.load_state_dict(ref.state_dict())
    assert half.update(5.0, 0.05, 50.0) == ref.update(5.0, 0.05, 50.0)


def test_per_position_entropy_weighter_matches_jax():
    port, ref = PerPositionEntropyWeighter(12, decay=0.7), jsched.PerPositionEntropyWeighter(
        12, decay=0.7)
    rng = np.random.default_rng(2)
    for t in (10, 12, 15):
        errors = (rng.random((6, t)) < rng.random(t)).astype(np.float32)
        mask = (np.arange(t)[None, :] < rng.integers(3, t + 1, 6)[:, None]).astype(np.float32)
        port.update(errors, mask)
        ref.update(errors, mask)
        np.testing.assert_array_equal(port.weights(), ref.weights())
    assert port.state_dict() == ref.state_dict()
    back = PerPositionEntropyWeighter(12)
    back.load_state_dict(port.state_dict())
    np.testing.assert_array_equal(back.weights(), ref.weights())
    assert np.argmax(port.weights()) == np.argmax(ref.weights())
