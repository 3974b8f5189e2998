"""Encoder and decoder of the port against the JAX package, on the same
random weights (loaded through ``params_from_jax``) and the same inputs,
at ``tiny_test_config``.

Tolerance: float32 everywhere; the two frameworks sum in other orders and
flax's LayerNorm takes the variance as E[x^2] - E[x]^2, so outputs agree
to 2e-5 absolute and relative.  Cache contents are compared the same way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu_torch.models import tiny_test_config
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import batch, jax_config, param_trees, port_models, to_torch

TOL = dict(rtol=2e-5, atol=2e-5)
CFG = tiny_test_config()
B = 3


@pytest.fixture(scope='module')
def setup():
    trees = param_trees(CFG)
    enc, dec = port_models(CFG, trees)
    data = batch(CFG, B)
    jenc = JaxEncoder(jax_config(CFG))
    jout = jax.jit(jenc.apply)(trees[0], data['element_indices'],
                               data['element_fractions'], data['element_mask'],
                               data['magpie'], data['tc'])
    return trees, enc, dec, data, jenc, jout


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_encoder_outputs_match_jax(setup):
    trees, enc, _, data, jenc, jout = setup
    t = to_torch(data)
    with torch.no_grad():
        out = enc(t['element_indices'], t['element_fractions'], t['element_mask'],
                  t['magpie'], t['tc'])
    assert set(out) == set(jout)
    for key, want in jout.items():
        if want is None:
            assert out[key] is None
        else:
            _close(out[key], want)
    hv = jenc.apply(trees[0], jout, method=JaxEncoder.heads_pred_for_decoder)
    _close(enc.heads_pred_for_decoder(out), hv)


def test_heads_from_z_matches_jax(setup):
    trees, enc, _, _, jenc, jout = setup
    want = jax.jit(lambda p, z: jenc.apply(p, z, method=JaxEncoder.heads_from_z))(
        trees[0], jout['z'])
    with torch.no_grad():
        got = enc.heads_from_z(torch.tensor(np.asarray(jout['z'])))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


def _conditioning(trees, jenc, jout, data):
    hv = jenc.apply(trees[0], jout, method=JaxEncoder.heads_pred_for_decoder)
    em = data['element_mask'].astype(np.float32)
    stoich = np.concatenate([data['element_fractions'] * em,
                             em.sum(1, keepdims=True)], 1)
    return np.asarray(jout['z']), stoich, np.asarray(hv)


def test_decoder_teacher_forced_matches_jax(setup):
    trees, _, dec, data, jenc, jout = setup
    z, stoich, hv = _conditioning(trees, jenc, jout, data)
    want = jax.jit(JaxDecoder(jax_config(CFG)).apply)(
        trees[1], z, data['tokens'], stoich, hv)
    with torch.no_grad():
        got = dec(torch.tensor(z), torch.tensor(data['tokens']).long(),
                  torch.tensor(stoich), torch.tensor(hv))
    for key in ('logits', 'stop_logits', 'type_logits', 'site_dup_logits', 'memory'):
        _close(got[key], want[key])
    np.testing.assert_array_equal(got['generated'].numpy(), np.asarray(want['generated']))


@pytest.mark.parametrize('pallas_decode', [False, True])
def test_decode_step_matches_jax(setup, pallas_decode):
    """Both cache layouts; the JAX side with ``pallas_decode=True`` runs its
    Pallas kernel in interpret mode on the CPU."""
    trees, _, _, data, jenc, jout = setup
    cfg = dataclasses.replace(CFG, pallas_decode=pallas_decode)
    _, dec = port_models(cfg, trees)
    jdec = JaxDecoder(jax_config(cfg))
    z, stoich, hv = _conditioning(trees, jenc, jout, data)
    memory = jdec.apply(trees[1], z, stoich, hv, method=JaxDecoder.build_memory)
    mkv = jdec.apply(trees[1], memory, method=JaxDecoder.memory_kv)
    jk, jv = jdec.apply(trees[1], B, method=JaxDecoder.init_cache)
    jstep = jax.jit(lambda p, tok, pos, k, v, m: jdec.apply(
        p, tok, pos, k, v, m, method=JaxDecoder.decode_step))

    with torch.no_grad():
        tmem = dec.build_memory(torch.tensor(z), torch.tensor(stoich),
                                torch.tensor(hv))
        tkv = dec.memory_kv(tmem)
        tk, tv = dec.init_cache(B)
        assert tuple(tk.shape) == tuple(jk.shape)
        tf = dec(torch.tensor(z), torch.tensor(data['tokens']).long(),
                 torch.tensor(stoich), torch.tensor(hv))
        for pos in range(5):
            tok = data['tokens'][:, pos]
            want, jk, jv = jstep(trees[1], jnp.asarray(tok), pos, jk, jv, mkv)
            got, tk, tv = dec.decode_step(torch.tensor(tok).long(), pos,
                                          tk, tv, tkv)
            for key in ('logits', 'stop_logits', 'type_logits', 'site_dup_logits'):
                _close(got[key], want[key])
            # the cached step reproduces the parallel forward
            _close(got['logits'], tf['logits'][:, pos].numpy())
        _close(tk, jk)
        _close(tv, jv)
