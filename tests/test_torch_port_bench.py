"""The port's compute dtype, the re-score's remat and the port's bench, on
the CPU at tiny widths.

- ``TrainConfig.compute_dtype`` reaches the models: with 'bfloat16' the
  decoder's teacher-forced logits are bf16 before the loss boundary, the
  parameters, gradients and AdamW moments float32, the losses float32;
  any other name is refused.
- The decode step hands the decode-step attention bf16 q, k_new, v_new
  and the bf16 caches themselves (no float32 copy in between).
- ``cast_weights_once`` gives the same outputs as casting at every call,
  and refuses a call with grad enabled.
- SCST's and RLOO's re-score runs under ``torch.utils.checkpoint``; loss
  and every gradient are bit-equal to the run without it.
- ``python -m superconductor_vae_tpu_torch.bench --quick`` prints bench.py's
  keys, and with ``--spec`` those of bench.py's speculative probe, its
  streams equal to the plain greedy scan's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from superconductor_vae_tpu_torch import bench
from superconductor_vae_tpu_torch.data import synthetic_dataset
from superconductor_vae_tpu_torch.models import (FormulaDecoder, init_params,
                                                 tiny_test_config)
from superconductor_vae_tpu_torch.models import decoder as decoder_module
from superconductor_vae_tpu_torch.models.layers import cast_weights_once
from superconductor_vae_tpu_torch.ops import rl
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)
from superconductor_vae_tpu_torch.training.evaluate import _to_device

import torch_port_threads  # noqa: F401  (one torch thread a process)

CFG = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0)
TCFG = dict(use_physics_z=True, magpie_proj_learnable=True,
            hungarian_enabled=False, use_round_trip=False)
B = 4


def _batch(cfg, b, seed=0):
    ds = synthetic_dataset(n=b, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim, seed=seed)
    return _to_device(ds.batch(np.arange(b)), 'cpu')


def _cond(cfg, b, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, cfg.latent_dim, generator=g).to(dtype),
            torch.rand(b, cfg.stoich_input_dim, generator=g).to(dtype),
            torch.randn(b, cfg.heads_input_dim, generator=g).to(dtype))


def test_compute_dtype_reaches_the_models():
    tc = TrainConfig(**TCFG, compute_dtype='bfloat16')
    state = create_train_state(CFG, tc, seed=0, device='cpu')
    bt = _batch(CFG, B)
    z, stoich, hv = _cond(CFG, B)
    with torch.no_grad():
        out = state.decoder(z, bt['tokens'], stoich, hv)
        enc = state.encoder(bt['element_indices'], bt['element_fractions'],
                            bt['element_mask'], bt['magpie'], bt['tc'])
    assert out['logits'].dtype == torch.bfloat16
    assert enc['z'].dtype == torch.bfloat16
    assert state.decoder.init_cache(2)[0].dtype == torch.bfloat16
    state, metrics = make_train_step(tc, build_luts(default_tokenizer(max_len=CFG.max_len),
                                                    'cpu'))(state, bt, 0, default_dyn(tc))
    assert {m.dtype for m in metrics.values()} == {torch.float32}
    assert all(torch.isfinite(m) for m in metrics.values())
    for params, opt in state.groups():
        for p in params:
            assert p.dtype == p.grad.dtype == torch.float32
            assert opt.state[p]['exp_avg'].dtype == opt.state[p]['exp_avg_sq'].dtype \
                == torch.float32


@pytest.mark.parametrize('name', ['float16', 'bf16', 'float64'])
def test_compute_dtype_refuses_other_names(name):
    with pytest.raises(ValueError, match='compute_dtype'):
        create_train_state(CFG, TrainConfig(**TCFG, compute_dtype=name), device='cpu')


def test_decode_step_hands_bf16_to_the_kernel(monkeypatch):
    cfg = dataclasses.replace(CFG, pallas_decode=True)
    dec = init_params(FormulaDecoder(cfg, device='cpu', dtype=torch.bfloat16),
                      torch.Generator().manual_seed(0)).eval()
    kc, vc = dec.init_cache(B)
    seen = []
    original = decoder_module.decode_step_attention

    def spy(q, k_new, v_new, k_cache, v_cache, position):
        seen.append(([t.dtype for t in (q, k_new, v_new, k_cache, v_cache)],
                     k_cache.untyped_storage().data_ptr(), v_cache.untyped_storage().data_ptr()))
        return original(q, k_new, v_new, k_cache, v_cache, position)
    monkeypatch.setattr(decoder_module, 'decode_step_attention', spy)
    with torch.no_grad():
        mkv = dec.memory_kv(dec.build_memory(*_cond(cfg, B)))
        dec.decode_step(torch.ones(B, dtype=torch.long), 0, kc, vc, mkv)
    assert len(seen) == cfg.num_layers
    for dtypes, kp, vp in seen:
        assert dtypes == [torch.bfloat16] * 5
        assert (kp, vp) == (kc.untyped_storage().data_ptr(), vc.untyped_storage().data_ptr())
    assert kc[:, :, :, 0].abs().sum() > 0           # written in place


def test_cast_weights_once_is_the_same_pass():
    dec = init_params(FormulaDecoder(CFG, device='cpu', dtype=torch.bfloat16),
                      torch.Generator().manual_seed(0)).eval()
    tokens = torch.randint(0, CFG.vocab_size, (B, CFG.max_len))
    with torch.no_grad():
        want = dec(*_cond(CFG, B)[:1], tokens, *_cond(CFG, B)[1:])['logits']
        with cast_weights_once(dec):
            got = dec(*_cond(CFG, B)[:1], tokens, *_cond(CFG, B)[1:])['logits']
    assert torch.equal(got, want)
    assert all(m.frozen is None for m in dec.modules() if hasattr(m, 'frozen'))
    with cast_weights_once(dec), pytest.raises(RuntimeError, match='no gradient'):
        dec(*_cond(CFG, B)[:1], tokens, *_cond(CFG, B)[1:])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('method', ['scst', 'rloo'])
def test_rescore_remat_is_bit_equal(monkeypatch, method, dtype):
    """Loss and every gradient (decoder parameters, z, stoich, heads_vec)
    with and without the checkpoint around the re-score."""
    luts = build_luts(default_tokenizer(max_len=CFG.max_len), 'cpu')
    cfg_rl = rl.RLConfig(method=method, max_len=CFG.max_len, n_samples_rloo=3)
    targets = _batch(CFG, B)['tokens'][:, 1:]
    fn = rl.scst_loss if method == 'scst' else rl.rloo_loss
    calls = []
    real = rl.checkpoint

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    def run(remat):
        monkeypatch.setattr(rl, 'checkpoint', counted if remat else
                            (lambda f, *a, use_reentrant: f(*a)))
        dec = init_params(FormulaDecoder(CFG, device='cpu', dtype=dtype),
                          torch.Generator().manual_seed(0)).train()
        z, stoich, hv = (x.float().requires_grad_() for x in _cond(CFG, B))
        loss, *_ = fn(dec, z, stoich, hv, targets, torch.Generator().manual_seed(1),
                      cfg_rl, luts, sc_weight=torch.ones(B))
        loss.backward()
        grads = {n: p.grad.clone() for n, p in dec.named_parameters() if p.grad is not None}
        return loss.detach(), grads, [x.grad for x in (z, stoich, hv)]

    with_remat, without = run(True), run(False)
    assert calls == [{'use_reentrant': False}]
    assert with_remat[0].item() != 0.0
    assert torch.equal(with_remat[0], without[0])
    assert with_remat[1].keys() == without[1].keys() and len(without[1]) > 0
    for k in without[1]:
        assert torch.equal(with_remat[1][k], without[1][k]), k
    for a, b in zip(with_remat[2], without[2]):
        assert torch.equal(a, b)


def test_bench_quick_prints_bench_py_keys(capsys):
    out = bench.main(['--quick', '--steps', '1'])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed.startswith('{') and '"metric"' in printed
    for key in ('metric', 'value', 'unit', 'vs_baseline', 'gen_formulas_per_s_per_chip',
                'gen_vs_baseline', 'rl_samples_per_s_per_chip', 'rl_vs_baseline',
                'rl_batch_size', 'compute_dtype', 'decode_route', 'gen_decode_steps',
                'rl_decode_steps', 'peak_gib', 'card', 'power_limit', 'device'):
        assert key in out, key
    assert out['metric'] == 'train_samples_per_s_quick' and out['value'] > 0
    assert out['compute_dtype'] == 'float32' and out['device'] == 'cpu'
    assert out['rl_samples_per_s_per_chip'] > 0 and out['gen_formulas_per_s_per_chip'] > 0
    assert len(out['rl_decode_steps']) == 3 * bench.RL_CHUNK
    assert len(out['gen_decode_steps']) == 5
    assert all(1 <= s <= 15 for s in out['rl_decode_steps'] + out['gen_decode_steps'])


def test_bench_quick_spec_prints_bench_py_keys(capsys):
    out = bench.main(['--quick', '--spec', '--steps', '1'])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert out['metric'] == 'speculative_generation_formulas_per_s_per_chip'
    for key in ('value', 'unit', 'vs_baseline', 'acceptance_rate', 'speedup_vs_plain_scan',
                'compute_dtype', 'decode_route', 'card', 'power_limit', 'device'):
        assert key in out, key
    assert out['rows_equal_to_plain_scan'] == 1.0 and out['device'] == 'cpu'     # float32
    assert out['rows_parted_beyond_ties'] == 0 and out['tie'] == 1e-4
    assert 0 < out['acceptance_rate'] <= 1 and out['n_iterations'] <= out['plain_steps']
