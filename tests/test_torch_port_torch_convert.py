"""The reference-checkpoint converter (checkpoint/torch_convert.py) and
``migrate_checkpoint from-torch`` against the JAX package's converter.

Reference state dicts are built from the converter's own name map, with
the shapes of the port's modules at narrow widths in the reference's
proportions (with and without the memory bottleneck) and ``np.random.default_rng`` values, the
fused q/k/v ``in_proj`` of every decoder layer as one [3d, d] weight, and
two reference parameters that have no counterpart (skipped by both):
- the port's encoder and decoder state dicts equal, bit for bit, JAX's
  ``convert_*_state`` followed by the port's ``params_from_jax``; the
  detected model config and the physics-Z projection equal JAX's;
- the converted decoder's teacher-forced logits and heads match the JAX
  decoder's on JAX's converted params (1e-5 relative, 1e-5 absolute);
- the CLI writes a params-only checkpoint that loads into the same
  parameters, the projection included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from superconductor_vae_tpu.checkpoint import torch_convert as jax_convert
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu_torch.checkpoint import load_checkpoint, params_from_jax
from superconductor_vae_tpu_torch.checkpoint import torch_convert as conv
from superconductor_vae_tpu_torch.models import FormulaDecoder, MaterialsEncoder
from superconductor_vae_tpu_torch.models.config import ModelConfig
from superconductor_vae_tpu_torch.scripts import migrate_checkpoint
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import jax_config

TOL = dict(rtol=1e-5, atol=1e-5)
# reference parameters the converters skip
UNMAPPED = {'encoder': 'element_encoder.element_embedding.property_encoder.0.weight',
            'decoder': 'skip_to_memory.0.weight'}


def _reference_checkpoint(cfg, seed=0):
    """A reference-layout checkpoint dict whose every mapped tensor is
    random, shaped as the port's parameter it maps onto."""
    rng = np.random.default_rng(seed)
    rand = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32) * 0.1)
    shapes = {'encoder': {k: tuple(v.shape) for k, v in
                          MaterialsEncoder(cfg, device='cpu').state_dict().items()},
              'decoder': {k: tuple(v.shape) for k, v in
                          FormulaDecoder(cfg, device='cpu').state_dict().items()}}
    out = {}
    for part, mapping in (('encoder', conv.encoder_name_map()),
                          ('decoder', conv.decoder_name_map(cfg))):
        sd = {}
        for kind, ref, port in mapping:
            if kind == 'param':
                sd[ref] = rand(shapes[part][port])
                continue
            sd[f'{ref}.weight'] = rand(shapes[part][f'{port}.weight'])
            if f'{port}.bias' in shapes[part]:
                sd[f'{ref}.bias'] = rand(shapes[part][f'{port}.bias'])
        sd[UNMAPPED[part]] = rand((3, 3))
        out[f'{part}_state_dict'] = sd
    d = cfg.d_model
    for i in range(cfg.num_layers):
        for attn in ('self_attn', 'multihead_attn'):
            tl = f'transformer_decoder.layers.{i}.{attn}'
            out['decoder_state_dict'][f'{tl}.in_proj_weight'] = rand((3 * d, d))
            out['decoder_state_dict'][f'{tl}.in_proj_bias'] = rand((3 * d,))
    out['physics_z_loss_fn_state_dict'] = {
        'magpie_loss.projection.weight': rand((62, cfg.magpie_dim)),
        'magpie_loss.projection.bias': rand((62,))}
    out['epoch'] = 7
    return out


# narrow widths in the reference's proportions (what the detection assumes:
# encoder_hidden (2f, f), decoder_hidden (f, 2f)); the rest ModelConfig()'s
_NARROW = dict(latent_dim=64, fusion_dim=32, magpie_dim=16, encoder_hidden=(64, 32),
               decoder_hidden=(32, 64), element_embed_dim=16, d_model=32, num_layers=2,
               dim_feedforward=64)
CONFIGS = {'direct': ModelConfig(**_NARROW),
           'bottleneck': ModelConfig(**_NARROW, memory_bottleneck_dim=24)}


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def converted(request):
    cfg = CONFIGS[request.param]
    ckpt = _reference_checkpoint(cfg)
    jcfg = jax_convert.model_config_from_torch(ckpt)
    jenc = jax_convert.convert_encoder_state(ckpt['encoder_state_dict'], jcfg)
    jdec = jax_convert.convert_decoder_state(ckpt['decoder_state_dict'], jcfg)
    pcfg = conv.model_config_from_torch(ckpt)
    return dict(cfg=cfg, ckpt=ckpt, jcfg=jcfg, jenc=jenc, jdec=jdec, pcfg=pcfg,
                enc=conv.convert_encoder_state(ckpt['encoder_state_dict'], pcfg),
                dec=conv.convert_decoder_state(ckpt['decoder_state_dict'], pcfg))


def test_config_is_jax_detection(converted):
    assert dataclasses.asdict(converted['pcfg']) == dataclasses.asdict(converted['jcfg'])
    for k in ('d_model', 'num_layers', 'vocab_size', 'latent_dim', 'memory_bottleneck_dim'):
        assert getattr(converted['pcfg'], k) == getattr(converted['cfg'], k), k


def test_state_dicts_equal_jax_then_params_from_jax(converted):
    enc, dec = params_from_jax(converted['jenc'], converted['jdec'], converted['pcfg'],
                               device='cpu')
    for got, module in ((converted['enc'], enc), (converted['dec'], dec)):
        want = module.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            assert torch.equal(got[k], v), k


def test_physics_z_projection_equals_jax(converted):
    got = conv.convert_physics_z_state(converted['ckpt'])
    want = jax_convert.convert_physics_z_state(converted['ckpt'])
    np.testing.assert_array_equal(got['weight'].numpy(), np.asarray(want['kernel']).T)
    np.testing.assert_array_equal(got['bias'].numpy(), np.asarray(want['bias']))
    assert conv.convert_physics_z_state({}) == {}


def test_teacher_forced_logits_match_jax(converted):
    cfg = converted['pcfg']
    dec = FormulaDecoder(cfg, device='cpu')
    dec.load_state_dict(converted['dec'], strict=True)
    dec.eval()
    rng = np.random.default_rng(3)
    b = 3
    z = rng.standard_normal((b, cfg.latent_dim)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32)
    stoich = rng.random((b, cfg.stoich_input_dim)).astype(np.float32)
    hv = rng.standard_normal((b, cfg.heads_input_dim)).astype(np.float32)
    want = JaxDecoder(jax_config(cfg)).apply(converted['jdec'], z, tokens, stoich, hv)
    with torch.no_grad():
        got = dec(torch.tensor(z), torch.tensor(tokens).long(), torch.tensor(stoich),
                  torch.tensor(hv))
    for key in ('logits', 'stop_logits', 'type_logits', 'site_dup_logits'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)


def test_from_torch_cli_round_trips(converted, tmp_path):
    src = tmp_path / 'ref.pt'
    torch.save(converted['ckpt'], src)
    path = migrate_checkpoint.main(['from-torch', str(src), '--out', str(tmp_path / 'out')])
    assert path.name == 'converted'
    restored, meta = load_checkpoint(path)
    assert meta['epoch'] == 7 and meta['model_config']['d_model'] == converted['cfg'].d_model
    for group, want in (('enc_params', converted['enc']), ('dec_params', converted['dec'])):
        assert restored[group].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(restored[group][k], v), k
    assert torch.equal(restored['pz_params']['weight'],
                       conv.convert_physics_z_state(converted['ckpt'])['weight'])
