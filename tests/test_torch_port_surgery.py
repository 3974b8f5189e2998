"""The port's model surgery (models/surgery.py) and its migration CLI
(scripts/migrate_checkpoint.py) against the JAX package, at tiny widths.

Every surgery function runs on the same parameters in both packages (the
JAX one on the numpy flax tree, the port's on its state dict through
``state_dict_from_flax``), at noise 0 and at noise > 0, and the results
agree to float32 rounding (1e-7 relative; they are equal in practice:
both run the same numpy arithmetic in the same order, the float64
division by a multiplicity included, and cast once to float32).  Then,
as tests/test_surgery.py does for JAX, the port's widened and deepened
decoders give the original port decoder's teacher-forced logits, stop
and type logits within 1e-4 (two widenings in a chain within 2e-4, as in
JAX's test) and its greedy streams, and the widened encoder its outputs
within 1e-4.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import superconductor_vae_tpu.models.surgery as jsurgery
from superconductor_vae_tpu_torch.checkpoint import load_checkpoint, save_params_checkpoint
from superconductor_vae_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from superconductor_vae_tpu_torch.models import (
    FormulaDecoder, MaterialsEncoder, config_from_meta, tiny_test_config)
from superconductor_vae_tpu_torch.models import surgery
from superconductor_vae_tpu_torch.scripts import migrate_checkpoint
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import batch, jax_config, param_trees, port_models, to_torch

CFG = dataclasses.replace(tiny_test_config(), magpie_dim=78)   # the corpus's
SURGERY_RTOL = 1e-7               # float32 rounding
FN_ATOL = 1e-4                    # function preservation
NOISES = (0.0, 0.01)


@pytest.fixture(scope='module')
def trees():
    return param_trees(CFG, seed=5)


@pytest.fixture(scope='module')
def inputs():
    return to_torch(batch(CFG, 3, seed=7))


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=SURGERY_RTOL, atol=0,
                                   err_msg=k)


def _jax_state(tree):
    return state_dict_from_flax(jax.tree.map(np.asarray, tree))


# -- each function against JAX's ----------------------------------------------------

@pytest.mark.parametrize('noise', NOISES)
def test_widen_dense_pair_and_layernorm(noise):
    rng = np.random.default_rng(0)
    k1, b1, k2 = (rng.standard_normal(s).astype(np.float32) for s in ((5, 6), (6,), (6, 4)))
    want = jsurgery.widen_dense_pair(k1, b1, k2, 10, np.random.default_rng(3), noise=noise)
    got = surgery.widen_dense_pair(torch.from_numpy(k1.T.copy()), torch.from_numpy(b1),
                                   torch.from_numpy(k2.T.copy()), 10,
                                   np.random.default_rng(3), noise=noise)
    for g, w in zip((got[0].T, got[1], got[2].T), want[:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=SURGERY_RTOL, atol=0)
    np.testing.assert_array_equal(got[3], want[3])
    # the pair's function: x -> k2(k1 x + b1) (no nonlinearity between)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    if noise == 0.0:
        np.testing.assert_allclose((x @ got[0].numpy().T + got[1].numpy()) @ got[2].numpy().T,
                                   (x @ k1 + b1) @ k2, rtol=1e-5, atol=1e-5)
    scale, bias = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6)
    for g, w in zip(surgery.widen_layernorm(torch.from_numpy(scale), bias, want[3]),
                    jsurgery.widen_layernorm(scale, bias, want[3])):
        np.testing.assert_allclose(g.numpy(), w, rtol=SURGERY_RTOL, atol=0)
    with pytest.raises(ValueError):
        surgery.widen_dense_pair(torch.from_numpy(k1.T.copy()), b1, k2.T, 4,
                                 np.random.default_rng(0))


def test_identity_layer_and_deepen(trees):
    dec = trees[1]
    want = _jax_state(jsurgery.deepen_decoder(dec, 2))
    got = surgery.deepen_decoder(_jax_state(dec), 2)
    _assert_same_state(got, want)
    layer = {k[len('layer_1.'):]: v for k, v in _jax_state(dec).items()
             if k.startswith('layer_1.')}
    ident = surgery.identity_decoder_layer(layer)
    _assert_same_state(ident, state_dict_from_flax(
        jsurgery.identity_decoder_layer(dec['params']['layer_1'])))
    assert all(float(v.abs().max()) == 0 for k, v in ident.items()
               if k.split('.')[0] in ('self_o', 'cross_o', 'ff2'))


def test_upgrade_tc_head(trees):
    rng = np.random.default_rng(4)
    enc = trees[0]
    bb = np.shape(enc['params']['tc_proj']['kernel'])[0]
    old = {'kernel0': rng.standard_normal((bb, 256)).astype(np.float32),
           'bias0': rng.standard_normal(256).astype(np.float32),
           'kernel1': rng.standard_normal((256, 1)).astype(np.float32),
           'bias1': rng.standard_normal(1).astype(np.float32)}
    want = _jax_state(jsurgery.upgrade_tc_head(enc, old))
    got = surgery.upgrade_tc_head(_jax_state(enc), {
        'weight0': torch.from_numpy(old['kernel0'].T.copy()), 'bias0': old['bias0'],
        'weight1': old['kernel1'].T, 'bias1': old['bias1']})
    _assert_same_state(got, want)


@pytest.mark.parametrize('noise', NOISES)
def test_expand_decoder_width_equals_jax(trees, noise):
    jcfg = jax_config(CFG)
    want = _jax_state(jsurgery.expand_decoder_width(trees[1], jcfg, 64, 128, noise=noise,
                                                    seed=3))
    got = surgery.expand_decoder_width(_jax_state(trees[1]), CFG, 64, 128, noise=noise, seed=3)
    _assert_same_state(got, want)
    assert dataclasses.asdict(surgery.widened_config(CFG, 64, 128)) == dataclasses.asdict(
        jsurgery.widened_config(jcfg, 64, 128))


@pytest.mark.parametrize('noise', NOISES)
def test_expand_encoder_widths_equals_jax(trees, noise):
    jcfg = jax_config(CFG)
    args = (64, (96, 64), (64, 96))
    want = _jax_state(jsurgery.expand_encoder_widths(trees[0], jcfg, *args, noise=noise,
                                                     seed=2))
    got = surgery.expand_encoder_widths(_jax_state(trees[0]), CFG, *args, noise=noise, seed=2)
    _assert_same_state(got, want)
    assert dataclasses.asdict(surgery.widened_encoder_config(CFG, *args)) == \
        dataclasses.asdict(jsurgery.widened_encoder_config(jcfg, *args))


def test_non_integer_factors_raise(trees):
    sd_dec, sd_enc = _jax_state(trees[1]), _jax_state(trees[0])
    with pytest.raises(ValueError, match='integer widening'):
        surgery.expand_decoder_width(sd_dec, CFG, 48, 96)
    with pytest.raises(ValueError, match='integer widening'):
        surgery.expand_encoder_widths(sd_enc, CFG, 48, (96, 64), (64, 96))
    with pytest.raises(ValueError, match='integer widening'):
        surgery.expand_encoder_widths(sd_enc, CFG, 64, (96,), (64, 96))


# -- function preservation in the port ------------------------------------------------

def _decoder(cfg, sd):
    dec = FormulaDecoder(cfg, device='cpu')
    dec.load_state_dict(sd, strict=True)
    return dec.eval()


def _tf(dec, inputs):
    z = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (3, CFG.latent_dim)).astype(np.float32))
    st = torch.linspace(-1, 1, 3 * CFG.stoich_input_dim).reshape(3, -1)
    hv = torch.linspace(1, -1, 3 * CFG.heads_input_dim).reshape(3, -1)
    toks = inputs['tokens'].clamp(4, 200)
    with torch.no_grad():
        out = dec(z, toks, st, hv)
        gen = greedy(dec, z, st, hv)
    return out, gen


def greedy(dec, z, st, hv):
    from superconductor_vae_tpu_torch.generation.generate import (
        GenerationConfig, generate_with_kv_cache)
    out = generate_with_kv_cache(dec, z, st, hv, None,
                                 GenerationConfig(max_len=CFG.max_len, temperature=0.0))
    return out['tokens'], out['margin']


def _assert_preserved(got, want, atol=FN_ATOL):
    for k in ('logits', 'stop_logits', 'type_logits'):
        np.testing.assert_allclose(got[0][k].numpy(), want[0][k].numpy(), atol=atol, err_msg=k)
    # greedy streams equal but where the top two logits are within 1e-4
    same = (got[1][0] == want[1][0]).all(dim=1)
    assert bool((same | (want[1][1].min(dim=1).values < 1e-4)).all())


def test_widened_and_deepened_decoders_preserve_function(trees, inputs):
    _, dec = port_models(CFG, trees)
    want = _tf(dec, inputs)
    sd = dec.state_dict()
    wide = _decoder(surgery.widened_config(CFG, 64, 128),
                    surgery.expand_decoder_width(sd, CFG, 64, 128))
    _assert_preserved(_tf(wide, inputs), want)
    deep = _decoder(dataclasses.replace(CFG, num_layers=CFG.num_layers + 2),
                    surgery.deepen_decoder(sd, 2))
    _assert_preserved(_tf(deep, inputs), want)
    cfg2 = surgery.widened_config(CFG, 64, 128)
    cfg3 = surgery.widened_config(cfg2, 128, 256)
    assert cfg3.pos_dim == CFG.d_model
    chained = _decoder(cfg3, surgery.expand_decoder_width(
        surgery.expand_decoder_width(sd, CFG, 64, 128), cfg2, 128, 256))
    _assert_preserved(_tf(chained, inputs), want, atol=2e-4)


def test_widened_encoder_preserves_function(trees, inputs):
    enc, _ = port_models(CFG, trees)
    args = (64, (96, 64), (64, 96))
    wide = MaterialsEncoder(surgery.widened_encoder_config(CFG, *args), device='cpu')
    wide.load_state_dict(surgery.expand_encoder_widths(enc.state_dict(), CFG, *args),
                         strict=True)
    x = [inputs[k] for k in ('element_indices', 'element_fractions', 'element_mask',
                             'magpie', 'tc')]
    with torch.no_grad():
        want, got = enc(*x), wide.eval()(*x)
    for k in ('z', 'tc_pred', 'sc_pred', 'fraction_pred', 'element_count_pred', 'hp_pred',
              'competence', 'tc_class_logits', 'magpie_pred', 'family_composed_14',
              'family_coarse_logits'):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=FN_ATOL, err_msg=k)
    m = np.sort(np.tile(np.arange(want['attended_input'].shape[-1]), 2))
    np.testing.assert_allclose(got['attended_input'].numpy(),
                               want['attended_input'].numpy()[..., m], atol=FN_ATOL)


# -- the migration CLI -----------------------------------------------------------------

@pytest.fixture(scope='module')
def tiny_ckpt(tmp_path_factory, trees):
    tmp = tmp_path_factory.mktemp('migrate')
    enc, dec = port_models(CFG, trees)
    meta = {'epoch': 3, 'model_config': dataclasses.asdict(CFG),
            'eval_gating': {'stop_boost': 0.0}, 'data_norm': {'skew_transform': 'rank_gauss'}}
    path = save_params_checkpoint(tmp / 'src', {'enc_params': enc.state_dict(),
                                                'dec_params': dec.state_dict()}, meta)
    return tmp, path, enc, dec


def _load(path):
    restored, meta = load_checkpoint(path)
    cfg = config_from_meta(meta['model_config'])
    enc = MaterialsEncoder(cfg, device='cpu')
    enc.load_state_dict(restored['enc_params'], strict=True)
    return restored, meta, cfg, enc.eval(), _decoder(cfg, restored['dec_params'])


@pytest.mark.parametrize('cmd,flags,tag', [
    ('deepen', ['--layers', '2'], 'deepened+2'),
    ('widen', ['--d-model', '64'], 'widened-64'),
    ('widen-encoder', ['--factor', '2'], 'encoder-widened-x2'),
    ('expand-vocab', ['--new-vocab', '4800'], 'vocab-expanded'),
])
def test_migrate_cli(tiny_ckpt, inputs, cmd, flags, tag):
    tmp, src, enc0, dec0 = tiny_ckpt
    path = migrate_checkpoint.main([cmd, str(src), '--out', str(tmp / cmd)] + flags)
    assert path == (tmp / cmd / tag).resolve()
    restored, meta, cfg, enc, dec = _load(path)
    assert meta['epoch'] == 3 and restored['step'] == 0
    assert meta['eval_gating'] == {'stop_boost': 0.0}
    assert meta['data_norm'] == {'skew_transform': 'rank_gauss'}
    want = {'deepen': dataclasses.replace(CFG, num_layers=4),
            'widen': surgery.widened_config(CFG, 64, 128),
            'widen-encoder': surgery.widened_encoder_config(CFG, 64, (96, 64), (64, 96)),
            'expand-vocab': dataclasses.replace(CFG, vocab_size=4800)}[cmd]
    assert cfg == want
    if cmd == 'expand-vocab':
        # the old rows unchanged; the new logits suppressed (bias -4)
        assert torch.equal(dec.token_embedding.weight[:CFG.vocab_size],
                           dec0.token_embedding.weight)
        assert bool((dec.out_d2.bias[CFG.vocab_size:] == -4.0).all())
    elif cmd == 'widen-encoder':
        x = [inputs[k] for k in ('element_indices', 'element_fractions', 'element_mask',
                                 'magpie', 'tc')]
        with torch.no_grad():
            np.testing.assert_allclose(enc(*x)['z'].numpy(), enc0(*x)['z'].numpy(),
                                       atol=FN_ATOL)
    else:
        _assert_preserved(_tf(dec, inputs), _tf(dec0, inputs))


def test_migrate_cli_refuses_from_torch(tmp_path):
    """``from-torch`` runs since the converter is ported
    (tests/test_torch_port_torch_convert.py); it refuses a file that is
    not there, and writes nothing."""
    with pytest.raises(FileNotFoundError):
        migrate_checkpoint.main(['from-torch', str(tmp_path / 'x.pt'), '--out',
                                 str(tmp_path / 'out')])
    assert not (tmp_path / 'out').exists()


def test_migrated_checkpoint_in_the_eval_cli_and_train(tiny_ckpt, tmp_path):
    """The deepened checkpoint through the eval CLI gives the source's
    exact match on the same rows, and ``train()`` resumes from it."""
    from superconductor_vae_tpu_torch.data import synthetic_dataset
    from superconductor_vae_tpu_torch.scripts import evaluate
    from superconductor_vae_tpu_torch.training import TrainConfig
    from superconductor_vae_tpu_torch.training.train_loop import train
    import gzip
    tmp, src, _, _ = tiny_ckpt
    deep = migrate_checkpoint.main(['deepen', str(src), '--out', str(tmp / 'deep_eval')])
    csv = Path(__file__).resolve().parents[1] / 'data/processed/jarvis_merged.csv.gz'
    with gzip.open(csv, 'rt') as fh:
        (tmp_path / 'head.csv').write_text(''.join(next(fh) for _ in range(49)))
    common = ['--cpu', '--csv', str(tmp_path / 'head.csv'), '--batch-size', '16']
    a = evaluate.main(['--checkpoint', str(src)] + common)
    b = evaluate.main(['--checkpoint', str(deep)] + common)
    assert a['n_evaluated'] == b['n_evaluated'] > 40
    assert (a['true_ar_exact'], a['tf_exact']) == (b['true_ar_exact'], b['tf_exact'])
    cfg = config_from_meta(json.loads((deep / 'meta.json').read_text())['model_config'])
    # the checkpoint's epoch is 3: train() resumes at epoch 4, the last of 5
    tcfg = TrainConfig(num_epochs=5, batch_size=16, max_formula_len=CFG.max_len,
                       use_physics_z=False, hungarian_enabled=False, use_round_trip=False,
                       resume=str(deep))
    out = train(model_config=cfg, train_config=tcfg, output_dir=str(tmp_path / 'run'),
                dataset=synthetic_dataset(32, max_len=CFG.max_len, magpie_dim=CFG.magpie_dim),
                log_fn=lambda *a, **k: None, device='cpu')
    assert len(out['history']) == 1 and len(out['state'].decoder.layers) == CFG.num_layers + 1
