"""Greedy KV-cache generation and the one-batch eval of the port against
the JAX package, with run4's decode gates (``meta.json`` ``eval_gating``:
stop boost 10, hard stop 0.8, type masking) and early exit.

Token streams must be identical.  Float outputs are float32 and agree to
2e-5 absolute and relative (other summation orders, flax's LayerNorm
variance formula), 1e-4 at run4 widths where the sums are longer.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.generation import GenerationConfig as JaxGenConfig
from superconductor_vae_tpu.generation import generate_with_kv_cache as jax_generate
from superconductor_vae_tpu.generation.generate import (
    _filter_top_k_top_p as jax_filter, sequence_mask as jax_sequence_mask)
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training.evaluate import _exact_match as jax_exact
from superconductor_vae_tpu.training.train_step import (
    stoich_conditioning as jax_stoich)
from superconductor_vae_tpu_torch.generation import (
    GenerationConfig, generate_with_kv_cache, sequence_mask)
from superconductor_vae_tpu_torch.generation.generate import _filter_top_k_top_p
from superconductor_vae_tpu_torch.models import config_from_meta, tiny_test_config
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    build_luts, eval_batch, eval_generation_config, eval_train_config)
from superconductor_vae_tpu_torch.training.evaluate import _exact_match
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import batch, jax_config, param_trees, port_models, to_torch

META = json.loads((Path(__file__).resolve().parents[1]
                   / 'results/run4/ckpt_snapshot/meta.json').read_text())
GATING = META['eval_gating']


def _rollout_trees(cfg, seed, stop_bias):
    """Random weights whose greedy rollouts end at varied steps: the stop
    head is turned so that its probability rises along the rollout and
    crosses the hard-stop threshold after a few steps, and the type head
    never predicts EOS (so rows end through the hard stop).  The biases
    were chosen by trying values at each width."""
    trees = param_trees(cfg, seed=seed)
    dec = trees[1]['params']
    dec['stop_d2']['kernel'] *= -1
    dec['stop_d2']['bias'][:] = stop_bias
    dec['type_d3']['bias'][:] = [0.0, 0.0, 0.0, -3.0, -3.0]
    return trees


def _eos_steps(tokens):
    return [list(row).index(2) if 2 in row else -1 for row in tokens.tolist()]


def _jax_eval(cfg, trees, data, gcfg_kw):
    """The body of the JAX package's eval_batch (training/evaluate.py)."""
    jcfg = jax_config(cfg)
    jenc, jdec = JaxEncoder(jcfg), JaxDecoder(jcfg)
    gcfg = JaxGenConfig(**gcfg_kw)
    type_masks = jnp.asarray(jax_tokenizer(max_len=cfg.max_len).type_masks)

    @jax.jit
    def run(enc_params, dec_params, b):
        enc_out = jenc.apply(enc_params, b['element_indices'], b['element_fractions'],
                             b['element_mask'], b['magpie'], b['tc'])
        hv = jenc.apply(enc_params, enc_out, method=JaxEncoder.heads_pred_for_decoder)
        stoich = jax_stoich(b)
        gen = jax_generate(jdec, dec_params, enc_out['z'], stoich, hv,
                           jax.random.PRNGKey(0), gcfg, type_masks=type_masks)
        tf = jdec.apply(dec_params, enc_out['z'], b['tokens'], stoich, hv)
        return {'generated': gen['tokens'], 'tf_pred': tf['generated'],
                'tc_pred': enc_out['tc_pred'], 'sc_pred': enc_out['sc_pred'],
                'z_norm': jnp.linalg.norm(enc_out['z'], axis=1),
                'family_composed_14': enc_out['family_composed_14']}
    return jax.tree.map(np.asarray, run(trees[0], trees[1], data))


def _port_eval(cfg, trees, data, gcfg):
    enc, dec = port_models(cfg, trees)
    luts = build_luts(default_tokenizer(max_len=cfg.max_len), device='cpu')
    return eval_batch(enc, dec, to_torch(data), gcfg, type_masks=luts['type_masks'])


def _gcfg(max_len):
    return eval_generation_config(eval_train_config(max_len, GATING), max_len)


def _gcfg_kw(max_len, early_exit=True):
    return dict(dataclasses.asdict(_gcfg(max_len)), early_exit=early_exit)


def _assert_eval_equal(got, want, tol):
    np.testing.assert_array_equal(got['generated'].numpy(), want['generated'])
    np.testing.assert_array_equal(got['tf_pred'].numpy(), want['tf_pred'])
    for key in ('tc_pred', 'sc_pred', 'z_norm', 'family_composed_14'):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=tol, atol=tol)


@pytest.mark.parametrize('pallas_decode', [False, True])
def test_eval_batch_matches_jax_tiny(pallas_decode):
    """The slice as a whole: encoder, memory, gated greedy early-exit
    generation (through either cache layout) and the TF forward."""
    cfg = dataclasses.replace(tiny_test_config(), pallas_decode=pallas_decode)
    trees = _rollout_trees(cfg, seed=2, stop_bias=2.2)
    data = batch(cfg, 6, seed=3)
    want = _jax_eval(cfg, trees, data, _gcfg_kw(cfg.max_len))
    got = _port_eval(cfg, trees, data, _gcfg(cfg.max_len))
    _assert_eval_equal(got, want, 2e-5)
    assert got['margin'].shape == got['generated'].shape
    ends = _eos_steps(got['generated'])
    assert min(ends) > 0 and len(set(ends)) > 1, ends


def test_eval_batch_matches_jax_run4_width_one_layer():
    """run4's widths from meta.json (magpie_dim 78), cut to one layer and six rows."""
    cfg = config_from_meta(META['model_config'], num_layers=1, pallas_decode=True)
    assert cfg.magpie_dim == 78 and cfg.d_model == 576 and cfg.head_dim == 72
    trees = _rollout_trees(cfg, seed=4, stop_bias=1.4)
    data = batch(cfg, 6, seed=5)
    want = _jax_eval(cfg, trees, data, _gcfg_kw(cfg.max_len))
    got = _port_eval(cfg, trees, data, _gcfg(cfg.max_len))
    _assert_eval_equal(got, want, 1e-4)
    ends = _eos_steps(got['generated'])
    assert min(ends) > 0 and len(set(ends)) > 1, ends


def test_fixed_loop_matches_jax_and_early_exit():
    """``early_exit=False`` runs every step; up to each row's first EOS it
    gives the early-exit stream."""
    cfg = tiny_test_config()
    trees = _rollout_trees(cfg, seed=2, stop_bias=2.2)
    enc, dec = port_models(cfg, trees)
    t = to_torch(batch(cfg, 6, seed=3))
    tm = build_luts(default_tokenizer(max_len=cfg.max_len), device='cpu')['type_masks']
    with torch.no_grad():
        out = enc(t['element_indices'], t['element_fractions'], t['element_mask'],
                  t['magpie'], t['tc'])
        hv = enc.heads_pred_for_decoder(out)
        em = t['element_mask'].float()
        stoich = torch.cat([t['element_fractions'] * em, em.sum(1, keepdim=True)], 1)
    streams = {}
    for early in (False, True):
        gcfg = GenerationConfig(**_gcfg_kw(cfg.max_len, early))
        streams[early] = generate_with_kv_cache(dec, out['z'], stoich, hv, None,
                                                gcfg, type_masks=tm)
    jdec = JaxDecoder(jax_config(cfg))
    want = jax.jit(lambda p, z, s, h: jax_generate(
        jdec, p, z, s, h, jax.random.PRNGKey(0),
        JaxGenConfig(**_gcfg_kw(cfg.max_len, False)),
        type_masks=jnp.asarray(tm.numpy())))(
            trees[1], out['z'].numpy(), stoich.numpy(), hv.numpy())
    np.testing.assert_array_equal(streams[False]['tokens'].numpy(),
                                  np.asarray(want['tokens']))
    np.testing.assert_allclose(streams[False]['entropy'].numpy(),
                               np.asarray(want['entropy']), rtol=2e-5, atol=2e-5)
    assert len(set(_eos_steps(streams[False]['tokens']))) > 1
    mask = streams[True]['mask'].bool()
    assert torch.equal(streams[True]['tokens'][mask], streams[False]['tokens'][mask])
    assert torch.equal(mask, streams[False]['mask'].bool())


def test_sequence_mask_and_exact_match_match_jax():
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 6, (16, 9)).astype(np.int32)
    np.testing.assert_array_equal(sequence_mask(torch.tensor(tokens)).numpy(),
                                  np.asarray(jax_sequence_mask(jnp.asarray(tokens))))
    targets = tokens.copy()
    gen = np.where(rng.random(tokens.shape) < 0.1, 7, tokens)
    np.testing.assert_array_equal(_exact_match(gen, targets), jax_exact(gen, targets))


@pytest.mark.parametrize('top_k,top_p', [(5, 1.0), (0, 0.7), (20, 0.9)])
def test_filter_top_k_top_p_matches_jax(top_k, top_p):
    logits = np.random.default_rng(9).standard_normal((4, 64)).astype(np.float32)
    want = jax_filter(jnp.asarray(logits), JaxGenConfig(top_k=top_k, top_p=top_p))
    got = _filter_top_k_top_p(torch.tensor(logits),
                              GenerationConfig(top_k=top_k, top_p=top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_draws_from_the_generator():
    cfg = tiny_test_config()
    _, dec = port_models(cfg, param_trees(cfg, seed=10))
    rng = np.random.default_rng(11)
    z = torch.tensor(rng.standard_normal((3, cfg.latent_dim)).astype(np.float32))
    stoich = torch.tensor(rng.random((3, cfg.stoich_input_dim)).astype(np.float32))
    hv = torch.tensor(rng.standard_normal((3, cfg.heads_input_dim)).astype(np.float32))
    gcfg = GenerationConfig(max_len=cfg.max_len, temperature=1.0, top_k=50)
    runs = [generate_with_kv_cache(dec, z, stoich, hv,
                                   torch.Generator().manual_seed(s), gcfg)
            for s in (0, 0, 1)]
    assert torch.equal(runs[0]['tokens'], runs[1]['tokens'])
    assert not torch.equal(runs[0]['tokens'], runs[2]['tokens'])
    assert (runs[0]['log_probs'] <= 0).all() and 'margin' not in runs[0]
    with pytest.raises(ValueError):
        generate_with_kv_cache(dec, z, stoich, hv, None, gcfg)
    # greedy_mask: the marked rows take the argmax, with log-prob 0
    greedy = generate_with_kv_cache(dec, z, stoich, hv, None,
                                    dataclasses.replace(gcfg, temperature=0.0))
    mixed = generate_with_kv_cache(dec, z, stoich, hv, torch.Generator().manual_seed(0),
                                   gcfg, greedy_mask=torch.tensor([True, False, True]))
    assert torch.equal(mixed['tokens'][[0, 2]], greedy['tokens'][[0, 2]])
    assert (mixed['log_probs'][[0, 2]] == 0).all()
