"""bf16 compute of the port against the JAX package's: flax modules built
with ``dtype=jnp.bfloat16`` (float32 parameters, bf16 compute, float32 at
the loss boundary) and the port's with ``dtype=torch.bfloat16``, on the
same numpy parameters and inputs, at ``tiny_test_config`` with a 512-wide
latent (the physics-Z loss reads latent coordinates up to 512).

bf16 results cannot agree bit for bit across frameworks: XLA's CPU bf16
GELU and softmax keep float32 between ops where torch rounds to bf16, and
the reverse.  So each comparison is held to JAX's own rounding on the same
inputs: with ``gap`` the largest difference between JAX in bf16 and JAX in
float32, the port's bf16 result must be within

    tol = min(3 * gap, 2**-4 * largest |float32 value|)

of JAX's bf16 result, and must differ from the port's own float32 result
(float32 in disguise fails).  Outputs before the loss boundary must be
bf16; parameters, gradients and AdamW moments float32.

Compared: the encoder's outputs, the decoder's teacher-forced logits and
heads, five decode steps in both cache layouts (the JAX kernel layout in
interpret mode) with their caches, greedy gated streams (a row may part
from JAX's only at a step where the top two logits are within twice the
logits' tolerance, and is not compared after it), the 17 loss terms of one
train step after the boundary cast (as one vector, each term relative to
its float32 value), that step's clipped gradients (through AdamW's first
moment) and its updated parameters.
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
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import train_step as jts
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.checkpoint import params_from_jax
from superconductor_vae_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from superconductor_vae_tpu_torch.generation import GenerationConfig, generate_with_kv_cache
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    TrainConfig, TrainState, build_luts, default_dyn, make_train_step)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_train_step import _batches, _to_torch
from torch_port_common import batch, jax_config, param_trees, to_torch

CFG = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0)
B = 4
DTYPES = {'f32': (jnp.float32, torch.float32), 'bf16': (jnp.bfloat16, torch.bfloat16)}
TCFG = dict(use_physics_z=True, magpie_proj_learnable=True,
            hungarian_enabled=False, use_round_trip=False)
# the 17 terms of multitask_loss's total, as its metrics name them
LOSS_TERMS = ('formula_loss', 'reinforce_loss', 'tc_loss', 'magpie_loss', 'kl_loss',
              'stoich_loss', 'count_loss', 'tc_class_loss', 'constraint_zoo_loss',
              'z_norm_penalty', 'stop_loss', 'type_loss', 'site_dup_loss', 'hp_loss',
              'sc_loss', 'family_loss', 'physics_z_loss')


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def held(got_b, got_f, want_b, want_f, what, scale=1.0):
    """The port's bf16 result ``got_b`` against JAX's ``want_b`` within
    min(3 gap, 2**-4 max |want_f|), gap = max |want_b - want_f|; and
    ``got_b`` not equal to the port's float32 ``got_f``.  Differences and
    values are in units of ``scale`` (1: absolute).  Returns the
    tolerance."""
    got_b, got_f, want_b, want_f = map(_np, (got_b, got_f, want_b, want_f))
    gap = (np.abs(want_b - want_f) / scale).max()
    tol = min(3 * gap, 2 ** -4 * (np.abs(want_f) / scale).max())
    err = (np.abs(got_b - want_b) / scale).max()
    assert err <= tol, f'{what}: port bf16 vs JAX bf16 {err:.3e} > {tol:.3e} (JAX gap {gap:.3e})'
    assert np.abs(got_b - got_f).max() > 0, f'{what}: the port\'s bf16 equals its float32'
    return tol


@pytest.fixture(scope='module')
def setup():
    trees = param_trees(CFG)
    data = batch(CFG, B)
    t = to_torch(data)
    out = {}
    for name, (jdt, tdt) in DTYPES.items():
        jenc = JaxEncoder(jax_config(CFG), dtype=jdt)
        jout = jax.jit(jenc.apply)(trees[0], data['element_indices'], data['element_fractions'],
                                   data['element_mask'], data['magpie'], data['tc'])
        jhv = jenc.apply(trees[0], jout, method=JaxEncoder.heads_pred_for_decoder)
        enc, dec = params_from_jax(trees[0], trees[1], CFG, device='cpu', dtype=tdt)
        with torch.no_grad():
            pout = enc(t['element_indices'], t['element_fractions'], t['element_mask'],
                       t['magpie'], t['tc'])
            phv = enc.heads_pred_for_decoder(pout)
        out[name] = dict(jout=jout, jhv=jhv, pout=pout, phv=phv, enc=enc, dec=dec)
    # the decoder's inputs, the same for every run: JAX float32's
    em = data['element_mask'].astype(np.float32)
    cond = (np.asarray(out['f32']['jout']['z']),
            np.concatenate([data['element_fractions'] * em, em.sum(1, keepdims=True)], 1),
            np.asarray(out['f32']['jhv']))
    return trees, data, out, cond


def test_encoder_outputs_match_jax(setup):
    _, _, out, _ = setup
    f, b = out['f32'], out['bf16']
    assert set(b['pout']) == set(b['jout'])
    for key, want in b['jout'].items():
        if want is None:
            assert b['pout'][key] is None
            continue
        assert b['pout'][key].dtype == torch.bfloat16, key
        held(b['pout'][key], f['pout'][key], want, f['jout'][key], f'encoder {key}')
    held(b['phv'], f['phv'], b['jhv'], f['jhv'], 'heads_vec')
    # the parameters stay float32
    assert {p.dtype for m in (b['enc'], b['dec']) for p in m.parameters()} == {torch.float32}


def _tf(setup):
    trees, data, out, cond = setup
    res = {}
    for name, (jdt, _) in DTYPES.items():
        want = jax.jit(JaxDecoder(jax_config(CFG), dtype=jdt).apply)(
            trees[1], *cond[:1], data['tokens'], *cond[1:])
        with torch.no_grad():
            got = out[name]['dec'](torch.tensor(cond[0]), torch.tensor(data['tokens']).long(),
                                   torch.tensor(cond[1]), torch.tensor(cond[2]))
        res[name] = (got, want)
    return res


def test_decoder_teacher_forced_matches_jax(setup):
    res = _tf(setup)
    (gf, wf), (gb, wb) = res['f32'], res['bf16']
    for key in ('logits', 'stop_logits', 'type_logits', 'site_dup_logits', 'memory'):
        assert gb[key].dtype == torch.bfloat16, key
        held(gb[key], gf[key], wb[key], wf[key], f'TF {key}')


@pytest.mark.parametrize('pallas_decode', [False, True])
def test_decode_step_matches_jax(setup, pallas_decode):
    """Five cached steps; the JAX kernel (pallas_decode) in interpret mode."""
    trees, data, _, cond = setup
    cfg = dataclasses.replace(CFG, pallas_decode=pallas_decode)
    runs = {}
    for name, (jdt, tdt) in DTYPES.items():
        jdec = JaxDecoder(jax_config(cfg), dtype=jdt)
        mem = jdec.apply(trees[1], *cond, method=JaxDecoder.build_memory)
        mkv = jdec.apply(trees[1], mem, method=JaxDecoder.memory_kv)
        jk, jv = jdec.apply(trees[1], B, method=JaxDecoder.init_cache)
        jstep = jax.jit(lambda p, tok, pos, k, v, m: jdec.apply(
            p, tok, pos, k, v, m, method=JaxDecoder.decode_step))
        _, dec = params_from_jax(trees[0], trees[1], cfg, device='cpu', dtype=tdt)
        steps = []
        with torch.no_grad():
            tkv = dec.memory_kv(dec.build_memory(*map(torch.tensor, cond)))
            tk, tv = dec.init_cache(B)
            assert tk.dtype == tdt and tuple(tk.shape) == tuple(jk.shape)
            for pos in range(5):
                tok = data['tokens'][:, pos]
                want, jk, jv = jstep(trees[1], jnp.asarray(tok), pos, jk, jv, mkv)
                got, tk, tv = dec.decode_step(torch.tensor(tok).long(), pos, tk, tv, tkv)
                steps.append((got, want))
        runs[name] = (steps, (tk, tv), (jk, jv))
    for pos in range(5):
        (gf, wf), (gb, wb) = runs['f32'][0][pos], runs['bf16'][0][pos]
        for key in ('logits', 'stop_logits', 'type_logits', 'site_dup_logits'):
            assert gb[key].dtype == torch.bfloat16
            held(gb[key], gf[key], wb[key], wf[key], f'decode step {pos} {key}')
    for i, what in enumerate(('K cache', 'V cache')):
        held(runs['bf16'][1][i], runs['f32'][1][i], runs['bf16'][2][i], runs['f32'][2][i], what)


def _rollout_trees(seed, stop_bias):
    """Random weights whose gated greedy rollouts end at varied steps: the
    stop head's probability rises along a rollout and crosses the hard-stop
    threshold after a few steps; the type head never predicts EOS."""
    trees = param_trees(CFG, seed=seed)
    dec = trees[1]['params']
    dec['stop_d2']['kernel'] *= -1
    dec['stop_d2']['bias'][:] = stop_bias
    dec['type_d3']['bias'][:] = [0.0, 0.0, 0.0, -3.0, -3.0]
    return trees


@pytest.mark.parametrize('pallas_decode', [False, True])
def test_greedy_streams_match_jax(setup, pallas_decode):
    """Gated greedy rollouts (stop boost 10, hard stop 0.8, type masking,
    early exit) from the same conditioning, each stream up to JAX's first
    EOS.  Where the port's stream parts
    from JAX's, that step must be a near-tie in bf16: its top two gated
    logits within twice the TF logits' tolerance, its stop probability
    within twice the stop logits' tolerance (times sigmoid's largest slope,
    1/4) of the hard-stop threshold, or its top two type logits within
    twice the type logits' tolerance; the row is not compared after it."""
    _, _, _, cond = setup
    cfg = dataclasses.replace(CFG, pallas_decode=pallas_decode)
    trees = _rollout_trees(seed=2, stop_bias=0.0)
    tm = build_luts(default_tokenizer(max_len=cfg.max_len), device='cpu')['type_masks']
    kw = dict(max_len=cfg.max_len, temperature=0.0, stop_boost=10.0,
              hard_stop_threshold=0.8, use_type_masking=True, early_exit=True)
    streams = {}
    for name, (jdt, tdt) in DTYPES.items():
        jdec = JaxDecoder(jax_config(cfg), dtype=jdt)
        want = jax.jit(lambda p, z, s, h: jax_generate(
            jdec, p, z, s, h, jax.random.PRNGKey(0), JaxGenConfig(**kw),
            type_masks=jnp.asarray(tm.numpy())))(trees[1], *cond)
        _, dec = params_from_jax(trees[0], trees[1], cfg, device='cpu', dtype=tdt)
        got = generate_with_kv_cache(dec, *map(torch.tensor, cond), None,
                                     GenerationConfig(**kw), type_masks=tm)
        streams[name] = (got, np.asarray(want['tokens']), dec)
    tol = {key: held(gb[key], gf[key], wb[key], wf[key], f'TF {key}')
           for (gf, wf), (gb, wb) in [tuple(_tf(setup).values())]
           for key in ('logits', 'stop_logits', 'type_logits')}
    got, want, dec = streams['bf16']
    tokens = got['tokens'].numpy()
    ends = [list(r).index(2) if 2 in r else -1 for r in want.tolist()]
    assert min(ends) > 0 and len(set(ends)) > 1, ends        # the gates matter
    # the port's heads along JAX's streams (BOS, then JAX's tokens)
    with torch.no_grad():
        tf = dec(*map(torch.tensor, cond[:1]),
                 torch.tensor(np.concatenate([np.ones((B, 1), np.int64), want], 1)),
                 *map(torch.tensor, cond[1:]))
    stop_p = torch.sigmoid(tf['stop_logits'].float()).numpy()
    top2 = tf['type_logits'].float().topk(2, dim=-1).values.numpy()
    parted = 0
    for r in range(B):
        # up to and including JAX's first EOS (later positions are not the stream)
        n = ends[r] + 1 if ends[r] >= 0 else len(want[r])
        diff = np.nonzero(tokens[r, :n] != want[r, :n])[0]
        if len(diff):
            s = diff[0]
            near = (float(got['margin'][r, s]) < 2 * tol['logits']
                    or abs(stop_p[r, s] - 0.8) < 0.25 * 2 * tol['stop_logits']
                    or top2[r, s, 0] - top2[r, s, 1] < 2 * tol['type_logits'])
            assert near, (r, s, float(got['margin'][r, s]), stop_p[r, s], top2[r, s], tol)
            parted += 1
    assert parted < B
    assert not np.array_equal(got['margin'].numpy(), streams['f32'][0]['margin'].numpy())


def _jax_step(trees, pz, bt, jdt):
    """One JAX train step from float32 parameters (compute dtype ``jdt``):
    (metrics, new state)."""
    jcfg = jax_config(CFG)
    jtc = JaxTrainConfig(**TCFG)
    tx_enc, tx_dec = jts.make_optimizer(jtc), jts.make_optimizer(jtc)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), enc_params=trees[0], dec_params=trees[1],
        enc_opt=tx_enc.init(trees[0]), dec_opt=tx_dec.init(trees[1]),
        pz_params=pz, pz_opt=tx_enc.init(pz))
    step = jts.make_train_step(JaxEncoder(jcfg, dtype=jdt), JaxDecoder(jcfg, dtype=jdt),
                               jtc, tx_enc, tx_dec,
                               jts.build_luts(jax_tokenizer(max_len=CFG.max_len)), donate=False)
    dyn = dict(jts.default_dyn(jtc), physz_w=jnp.asarray(1.0, jnp.float32))
    state, metrics = step(state, bt, jax.random.PRNGKey(0), dyn)
    return jax.tree.map(np.asarray, metrics), jax.tree.map(np.asarray, state)


def _mu(opt_state):
    inner = opt_state[1].inner_state
    return next(s for s in inner if hasattr(s, 'mu')).mu


@pytest.fixture(scope='module')
def steps(setup):
    """One train step of 4 CSV rows, JAX and the port, in each dtype."""
    trees = setup[0]
    pz = jax.tree.map(np.asarray, jax_init_proj(jax.random.PRNGKey(3), CFG.magpie_dim))
    bt = _batches(CFG)[0]
    runs = {}
    for name, (jdt, tdt) in DTYPES.items():
        jm, jstate = _jax_step(trees, pz, bt, jdt)
        enc, dec, proj = params_from_jax(trees[0], trees[1], CFG, device='cpu', dtype=tdt,
                                         pz_params=pz)
        tc = TrainConfig(**TCFG, compute_dtype={'f32': 'float32', 'bf16': 'bfloat16'}[name])
        state = TrainState.from_modules(enc, dec, tc, proj)
        state, pm = make_train_step(tc, build_luts(default_tokenizer(max_len=CFG.max_len),
                                                   'cpu'))(
            state, _to_torch(bt), 0, dict(default_dyn(tc), physz_w=1.0))
        runs[name] = dict(jm=jm, jstate=jstate, pm=pm, state=state)
    return runs


def test_train_step_loss_terms_match_jax(steps):
    """The 17 terms as one vector, each relative to its float32 value (a
    scalar mean's rounding error partly cancels, so one term's own gap
    says little); then the total."""
    f, b = steps['f32'], steps['bf16']
    assert all(b['pm'][k].dtype == torch.float32 for k in LOSS_TERMS)
    vec = {name: np.array([float(run[k]) for k in LOSS_TERMS])
           for name, run in (('pb', b['pm']), ('pf', f['pm']), ('jb', b['jm']), ('jf', f['jm']))}
    scale = np.maximum(np.abs(vec['jf']), 1e-30)     # reinforce_loss is 0 without RL
    held(vec['pb'], vec['pf'], vec['jb'], vec['jf'], 'the 17 loss terms', scale=scale)
    held(b['pm']['total'], f['pm']['total'], b['jm']['total'], f['jm']['total'], 'total')


def _port_trees(state):
    """{group: {name: (param, AdamW first moment)}} of the port's state."""
    out = {}
    for g, (module, opt) in zip(('enc', 'dec', 'pz'),
                                ((state.encoder, state.enc_opt), (state.decoder, state.dec_opt),
                                 (state.pz_proj, state.pz_opt))):
        out[g] = {n: (p.detach(), opt.state[p]['exp_avg'], opt.state[p]['exp_avg_sq'])
                  for n, p in module.named_parameters()}
    return out


def _flat(tree_dict, names):
    return np.concatenate([_np(tree_dict[n]).ravel() for n in names])


def test_train_step_gradients_and_params_match_jax(steps):
    """Per group: the clipped gradients through AdamW's first moment, and
    the updated parameters; all float32."""
    f, b = steps['f32'], steps['bf16']
    pf, pb = _port_trees(f['state']), _port_trees(b['state'])
    for g in ('enc', 'dec', 'pz'):
        names = sorted(pb[g])
        assert {t.dtype for v in pb[g].values() for t in v} == {torch.float32}, g
        mu = {k: {n: v for n, v in state_dict_from_flax(
            jax.tree.map(np.asarray, _mu(getattr(s, f'{g}_opt')))).items()}
            for k, s in (('f', f['jstate']), ('b', b['jstate']))}
        held(_flat({n: v[1] for n, v in pb[g].items()}, names),
             _flat({n: v[1] for n, v in pf[g].items()}, names),
             _flat(mu['b'], names), _flat(mu['f'], names), f'{g} AdamW mu')
        params = {k: state_dict_from_flax(jax.tree.map(np.asarray, getattr(s, f'{g}_params')))
                  for k, s in (('f', f['jstate']), ('b', b['jstate']))}
        held(_flat({n: v[0] for n, v in pb[g].items()}, names),
             _flat({n: v[0] for n, v in pf[g].items()}, names),
             _flat(params['b'], names), _flat(params['f'], names), f'{g} updated params')
