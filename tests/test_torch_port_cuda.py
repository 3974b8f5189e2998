"""The kernels on the card against their plain PyTorch versions (K1, the
decode-step attention; K2, the flash-attention forward), one train step
on the card against the same step on the CPU (without and with the set
decoder and the round trip, whose rollout runs K1), the dataset eval through
K1 against the plain attention path, K1's bf16 instance at the bench's
shapes and in a bf16 greedy rollout against the plain path, train() on
the card with K1 in its eval and RL rollouts and a checkpoint round trip,
the bench's --spec probe, and the soft-token passes' shared dropout masks
through the card's generator.

Needs an NVIDIA GPU and nvcc, and imports no JAX, so that it runs on a
machine with the card only:
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
Elsewhere every test skips.

Tolerance: K1 float32 output 1e-5 absolute and relative (other summation
order); bfloat16 output one bf16 ulp (2**-7 relative) plus 1e-3
absolute, since both round a float32 result once.  Cache rows are copies
and must be equal exactly, at every T, position and Dh.  K2 float32 2e-5 (the JAX tests' tolerance);
bfloat16 two bf16 ulp (2**-6 relative) plus 2e-3 absolute: the output is
rounded once, and the probabilities are rounded to bf16 against the
running max in the kernel and the final max in the plain version.  A
ragged Dh is padded by the wrapper and held to the same tolerances.  The
train step's metrics 1e-4 relative (float32, other summation orders).  The
eval's token streams must be equal, except where the top two logits were
within 1e-4 (K1 sums in another order than the plain path).
"""

from pathlib import Path

import pytest
import torch

from superconductor_vae_tpu_torch.ops.decode_attention import (
    decode_step_attention, decode_step_attention_ref)
from superconductor_vae_tpu_torch.ops.fused_attention import (
    flash_attention, flash_attention_ref, fused_attention)

import torch_port_threads  # noqa: F401  (one torch thread a process)

pytestmark = pytest.mark.cuda
CSV = Path(__file__).resolve().parents[1] / 'data/processed/jarvis_merged.csv.gz'


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(dev, b, t, dtype, seed, dh=72):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = [torch.randn(b, 8, dh, generator=g, device=dev).to(dtype) for _ in range(3)]
    caches = [torch.randn(b, 8, t, dh, generator=g, device=dev).to(dtype) for _ in range(2)]
    return rows + caches


# (B, T, position, Dh): the main path's shapes, then T past one 32-slot tile
# at the first, middle and last slot and on both sides of a tile edge, the
# kernel's other widths (Dh 64, 128, 256), Dh 66 and 70 (not whole 16-byte
# vectors in either dtype: the instance with element loads), and the
# batches of RL rollouts
K1_CASES = [pytest.param(1, 1, 0, 72, id='1-1-0'), pytest.param(3, 30, 0, 72, id='3-30-0'),
            pytest.param(5, 30, 17, 72, id='5-30-17'),
            pytest.param(256, 30, 29, 72, id='256-30-29'),
            pytest.param(2, 32, 31, 72, id='2-32-31'),
            (2, 33, 0, 72), (2, 33, 31, 72), (2, 33, 32, 72), (3, 38, 19, 72), (3, 38, 37, 72),
            (2, 64, 32, 72), (2, 64, 63, 72), (1, 257, 0, 72), (1, 257, 128, 72),
            (2, 257, 200, 72), (1, 257, 256, 72),
            (3, 38, 37, 64), (3, 38, 37, 128), (2, 38, 32, 256), (2, 30, 29, 256),
            (1, 257, 200, 256), (3, 38, 37, 66), (3, 30, 7, 66), (2, 257, 200, 70),
            (512, 30, 29, 72), (1024, 30, 29, 72),
            # the round trip's rollouts: a tenth of a batch of 256 and 512
            (25, 30, 0, 72), (25, 30, 29, 72), (51, 30, 14, 72), (51, 30, 29, 72)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,t,position,dh', K1_CASES)
def test_kernel_matches_plain_version(cuda, dtype, b, t, position, dh):
    q, kn, vn, kc, vc = _inputs(cuda, b, t, dtype, seed=position, dh=dh)
    kc_ref, vc_ref = kc.clone(), vc.clone()
    before = decode_step_attention.launches
    out = decode_step_attention(q, kn, vn, kc, vc, position)
    ref = decode_step_attention_ref(q, kn, vn, kc_ref, vc_ref, position)
    torch.cuda.synchronize()
    assert decode_step_attention.launches == before + 1
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref)


def test_kernel_rejects_what_it_cannot_take(cuda):
    q, kn, vn, kc, vc = _inputs(cuda, 2, 30, torch.float32, seed=0)
    with pytest.raises(ValueError):                     # position past the cache
        decode_step_attention(q, kn, vn, kc, vc, 30)
    with pytest.raises(ValueError):                     # Dh > 256
        wide = [torch.zeros(2, 8, 260, device=cuda) for _ in range(3)]
        cache = torch.zeros(2, 8, 30, 260, device=cuda)
        decode_step_attention(*wide, cache, cache.clone(), 0)
    with pytest.raises(TypeError):                      # mixed dtypes
        decode_step_attention(q.half(), kn, vn, kc, vc, 0)
    with pytest.raises(ValueError):                     # not contiguous
        decode_step_attention(q, kn, vn, kc.transpose(1, 2).contiguous().transpose(1, 2), vc, 0)


K2_SHAPES = [(2, 128, 2, 64), (2, 256, 2, 72), (2, 128, 2, 128), (2, 100, 2, 72),
             (1, 1, 1, 8), (3, 65, 8, 72), (64, 256, 8, 72)]
# the kernels' other padded widths (float32 64, 72, 128, 256 and bfloat16
# 64, 80, 128, 256 in shared memory) and Dh past 128, ragged T, B*H=1
K2_WIDE_SHAPES = [(1, 17, 1, 96), (2, 129, 3, 80), (1, 256, 1, 256), (2, 100, 2, 200),
                  (2, 64, 2, 136), (1, 5, 1, 256)]
# Dh that is not a whole number of 16-byte vectors: the wrapper pads it
K2_RAGGED = {torch.float32: (2, 130, 2, 66), torch.bfloat16: (2, 130, 2, 70)}


@pytest.mark.parametrize('dtype,b,t,h,dh',
                         [(torch.float32, *s) for s in K2_SHAPES]
                         + [(torch.bfloat16, *s) for s in K2_SHAPES + K2_WIDE_SHAPES]
                         + [(torch.float32, *s) for s in K2_WIDE_SHAPES]
                         + [(dt, *s) for dt, s in K2_RAGGED.items()])
def test_flash_attention_matches_plain_version(cuda, dtype, b, t, h, dh):
    g = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn(b, t, h, dh, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2 ** -6, atol=2e-3))
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_flash_attention_dispatch_and_refusals(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 128, 2, 72, generator=g, device=cuda) for _ in range(3))
    before = flash_attention.launches
    out = fused_attention(q, k, v, causal=True)                 # T >= 128: K2
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out, flash_attention_ref(q, k, v), rtol=2e-5, atol=2e-5)
    short = [x[:, :29].contiguous() for x in (q, k, v)]         # the model's T: plain
    out = fused_attention(*short, causal=True)
    assert flash_attention.launches == before + 1
    from superconductor_vae_tpu_torch.ops.attention import causal_mask, mha_attention
    assert torch.equal(out, mha_attention(*short, causal_mask(29, device=cuda)))
    with pytest.raises(ValueError):                             # tq != tk
        flash_attention(q, k[:, :64], v[:, :64])
    with pytest.raises(ValueError):                             # not contiguous
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):                             # Dh > 256 in float32
        big = torch.zeros(1, 8, 1, 260, device=cuda)
        flash_attention(big, big, big)
    with pytest.raises(ValueError):                             # Dh > 256 in bfloat16
        big = torch.zeros(1, 8, 1, 264, device=cuda, dtype=torch.bfloat16)
        flash_attention(big, big, big)
    with pytest.raises(TypeError):                              # mixed dtypes
        flash_attention(q.bfloat16(), k, v)
    with pytest.raises(RuntimeError, match='no gradient'):
        flash_attention(q.requires_grad_(), k, v)
    assert flash_attention.launches == before + 1


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One step at tiny widths (512-wide latent for the physics-Z blocks),
    dropout off, from the same seed on the card and on the CPU."""
    import dataclasses
    from superconductor_vae_tpu_torch.models import tiny_test_config
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)

    cfg = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0)
    tc = TrainConfig(hungarian_enabled=False, use_round_trip=False)
    dyn = dict(default_dyn(tc), physz_w=1.0)
    rng = torch.Generator().manual_seed(1)
    b = 6
    n_el = torch.randint(1, 6, (b,), generator=rng)
    mask = torch.arange(12)[None] < n_el[:, None]
    frac = torch.rand(b, 12, generator=rng) * mask
    batch = {
        'element_indices': torch.randint(1, 90, (b, 12), generator=rng) * mask,
        'element_fractions': frac / frac.sum(1, keepdim=True), 'element_mask': mask,
        'magpie': torch.randn(b, cfg.magpie_dim, generator=rng),
        'tc': torch.randn(b, generator=rng),
        'tokens': torch.randint(5, 200, (b, cfg.max_len), generator=rng),
        'is_sc': torch.tensor([1, 1, 0, 1, 0, 1]), 'hp': torch.zeros(b),
        'family': torch.randint(0, 14, (b,), generator=rng),
        'comp_targets': torch.randn(b, 15, generator=rng),
    }
    metrics = []
    for dev in (cuda, torch.device('cpu')):
        state = create_train_state(cfg, tc, seed=0, device=dev)
        step = make_train_step(tc, build_luts(default_tokenizer(max_len=cfg.max_len), dev))
        _, m = step(state, {k: x.to(dev) for k, x in batch.items()}, 0, dyn)
        metrics.append({k: x.item() for k, x in m.items()})
    for key, want in metrics[1].items():
        assert metrics[0][key] == pytest.approx(want, rel=1e-4, abs=1e-6), key


def test_evaluate_autoregressive_through_k1_matches_plain_path(cuda):
    """evaluate_autoregressive on the corpus's first 512 rows (run4's
    normalisation) at tiny width with seeded weights, the stop and type
    heads fixed so that every rollout runs all 29 steps: through K1 and
    through the plain attention path, the same results row by row, except
    rows whose decode met a near-tie."""
    import dataclasses
    import numpy as np
    from superconductor_vae_tpu_torch.data import load_dataset
    from superconductor_vae_tpu_torch.models import (
        FormulaDecoder, MaterialsEncoder, init_params, tiny_test_config)
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, eval_batch, eval_generation_config, eval_train_config,
        evaluate_autoregressive)
    from superconductor_vae_tpu_torch.training.evaluate import _to_device

    cfg = dataclasses.replace(tiny_test_config(), magpie_dim=78, max_len=30, pallas_decode=True)
    ds = load_dataset(CSV, skew_transform='rank_gauss', limit=600)
    gen = torch.Generator().manual_seed(0)
    enc = init_params(MaterialsEncoder(cfg, device=cuda), gen).eval()
    k1 = init_params(FormulaDecoder(cfg, device=cuda), gen).eval()
    with torch.no_grad():
        k1.stop_d2.weight.zero_()
        k1.stop_d2.bias.fill_(-4.0)
        k1.type_d3.bias[4] = -30.0
    plain = FormulaDecoder(dataclasses.replace(cfg, pallas_decode=False), device=cuda).eval()
    plain.load_state_dict(k1.state_dict())
    tcfg, tok = eval_train_config(cfg.max_len), default_tokenizer(max_len=cfg.max_len)
    luts = build_luts(tok, device=cuda)
    rows = np.arange(512)
    outs, launched = [], []
    for dec in (k1, plain):
        before = decode_step_attention.launches
        outs.append(evaluate_autoregressive(enc, dec, ds, tcfg, luts, tokenizer=tok,
                                            sample_indices=rows, collect_errors=True))
        launched.append(decode_step_attention.launches - before)
    got, want = outs
    assert launched == [2 * 2 * 29, 0]        # 2 batches x 2 layers x 29 steps
    assert got['n_evaluated'] == want['n_evaluated'] == 512
    np.testing.assert_array_equal(got['position_errors'], want['position_errors'])
    streams = [{e['index']: e['generated'] for e in o['error_records']} for o in outs]
    differ = [r for r in rows if streams[0].get(r) != streams[1].get(r)
              or got['per_sample_ar_exact'][r] != want['per_sample_ar_exact'][r]]
    gcfg = eval_generation_config(tcfg, cfg.max_len)
    for r in differ:
        first = r // 256 * 256
        batch = _to_device(ds.batch(rows[first:first + 256]), cuda)
        a, p = (eval_batch(enc, dec, batch, gcfg, type_masks=luts['type_masks'])
                for dec in (k1, plain))
        i = r - first
        step = int((a['generated'][i] != p['generated'][i]).int().argmax())
        assert min(a['margin'][i, step].item(), p['margin'][i, step].item()) < 1e-4, r
    assert len(differ) <= 5, differ


@pytest.mark.parametrize('b', [512, 1024])
def test_kernel_bf16_at_the_bench_shapes(cuda, b):
    """K1's bf16 instance as the bench's paths run it: the gen probe's 512
    rows and the SCST rollout of 512 (1,024 rows), T=30, Dh=72, at every
    position."""
    for position in range(30):
        q, kn, vn, kc, vc = _inputs(cuda, b, 30, torch.bfloat16, seed=position)
        kc_ref, vc_ref = kc.clone(), vc.clone()
        out = decode_step_attention(q, kn, vn, kc, vc, position)
        ref = decode_step_attention_ref(q, kn, vn, kc_ref, vc_ref, position)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
        assert torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref)


def test_bf16_greedy_rollout_through_k1_matches_plain_path(cuda):
    """A bf16 greedy rollout (bench.py's gates, the stop and type heads
    fixed so that it runs all 29 steps) of 256 rows at ModelConfig()'s
    widths cut to 2 layers, with seeded weights, through K1 and through the
    plain attention path: over K1's stream forced into both, their token
    logits and top two type logits differ by at most half of 2**-4; the streams are equal
    except where the top two gated logits or the top two type logits were
    within 2**-4 in either run (random type heads are close: about a third
    of the rows), in at most half of the rows.  K1's bf16 instance runs once a layer a step."""
    import dataclasses
    from superconductor_vae_tpu_torch.bench import gen_config
    from superconductor_vae_tpu_torch.models import FormulaDecoder, ModelConfig, init_params
    from superconductor_vae_tpu_torch.models.layers import cast_weights_once
    from superconductor_vae_tpu_torch.generation import generate_with_kv_cache, sequence_mask
    from superconductor_vae_tpu_torch.tokenizer import BOS_ID, EOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import build_luts

    tie, b = 2 ** -4, 256
    cfg = dataclasses.replace(ModelConfig(), num_layers=2, pallas_decode=True)
    k1 = init_params(FormulaDecoder(cfg, device=cuda, dtype=torch.bfloat16),
                     torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        k1.stop_d2.weight.zero_()
        k1.stop_d2.bias.fill_(-4.0)
        k1.type_d3.bias[4] = -30.0
    plain = FormulaDecoder(dataclasses.replace(cfg, pallas_decode=False), device=cuda,
                           dtype=torch.bfloat16).eval()
    plain.load_state_dict(k1.state_dict())
    g = torch.Generator(device=cuda).manual_seed(1)
    cond = (torch.randn(b, cfg.latent_dim, generator=g, device=cuda),
            torch.rand(b, cfg.stoich_input_dim, generator=g, device=cuda),
            torch.randn(b, cfg.heads_input_dim, generator=g, device=cuda))
    tm = build_luts(default_tokenizer(max_len=cfg.max_len), device=cuda)['type_masks']
    by_dtype = dict(decode_step_attention.launches_by_dtype)
    runs = [generate_with_kv_cache(d, *cond, None, gen_config(cfg), type_masks=tm)
            for d in (k1, plain)]
    assert decode_step_attention.launches_by_dtype[torch.bfloat16] \
        == by_dtype[torch.bfloat16] + cfg.num_layers * (cfg.max_len - 1)
    assert not bool((runs[0]['tokens'] == EOS_ID).any())     # all 29 steps
    worst = 0.0
    type_gap = [torch.zeros_like(r['margin']) for r in runs]
    with torch.no_grad(), cast_weights_once(k1), cast_weights_once(plain):
        state = [(d.memory_kv(d.build_memory(*cond)), *d.init_cache(b)) for d in (k1, plain)]
        tok = torch.full((b,), BOS_ID, dtype=torch.long, device=cuda)
        for pos in range(cfg.max_len - 1):
            heads = [d.decode_step(tok, pos, kc, vc, m)[0]
                     for d, (m, kc, vc) in zip((k1, plain), state)]
            # the token logits, and the type logits that pick the mask (each
            # run's top two)
            top2 = [h['type_logits'].float().topk(2, dim=-1).values for h in heads]
            worst = max(worst, (heads[0]['logits'].float()
                                - heads[1]['logits'].float()).abs().max().item(),
                        (top2[0] - top2[1]).abs().max().item())
            for gap, t2 in zip(type_gap, top2):
                gap[:, pos] = t2[:, 0] - t2[:, 1]
            tok = runs[0]['tokens'][:, pos]
    assert 2 * worst <= tie, worst
    mask = sequence_mask(runs[1]['tokens']).bool()
    diff = (runs[0]['tokens'] != runs[1]['tokens']) & mask
    for r in diff.any(dim=1).nonzero()[:, 0].tolist():
        s = int(diff[r].int().argmax())
        near = min(min(run['margin'][r, s].item(), gap[r, s].item())
                   for run, gap in zip(runs, type_gap))
        assert near < tie, r
    parted = int(diff.any(dim=1).sum())
    assert parted <= b // 2, parted


def test_train_on_the_card_with_k1_and_a_checkpoint_round_trip(cuda, tmp_path, monkeypatch):
    """train() at tiny width on the card for 2 epochs, the second an RL
    epoch, K1 in the rollouts: K1 launched once a layer at every decode step
    of the eval's and the RL epoch's rollouts; the last checkpoint loaded
    back equals the returned state bit for bit."""
    import dataclasses
    import numpy as np
    from superconductor_vae_tpu_torch.checkpoint import latest_checkpoint, load_checkpoint
    from superconductor_vae_tpu_torch.data import synthetic_dataset
    from superconductor_vae_tpu_torch.models import tiny_test_config
    from superconductor_vae_tpu_torch.ops import rl
    from superconductor_vae_tpu_torch.ops.rl import RLConfig
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID
    from superconductor_vae_tpu_torch.training import TrainConfig, evaluate, train

    steps = []

    def recording(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            is_eos = out['tokens'] == EOS_ID
            steps.append(out['tokens'].shape[1] if not bool(is_eos.any(dim=1).all())
                         else int(is_eos.int().argmax(dim=1).max()) + 1)
            return out
        return call
    monkeypatch.setattr(evaluate, 'generate_with_kv_cache',
                        recording(evaluate.generate_with_kv_cache))
    monkeypatch.setattr(rl, '_rollout', recording(rl._rollout))
    cfg = dataclasses.replace(tiny_test_config(), pallas_decode=True)
    tc = TrainConfig(num_epochs=2, batch_size=16, max_formula_len=cfg.max_len,
                     use_physics_z=False, hungarian_enabled=False, use_round_trip=False,
                     eval_interval=1, eval_max_batches=2, checkpoint_interval=2,
                     rl_reactivation_min_exact=0.0, rl_reactivation_window=2,
                     rl_reactivation_force_exact=1.0, rl_min_ar_exact=0.0,
                     rl=RLConfig(max_len=cfg.max_len))
    before = decode_step_attention.launches
    out = train(model_config=cfg, train_config=tc,
                dataset=synthetic_dataset(n=64, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim),
                output_dir=tmp_path, log_fn=lambda *a: None)
    launched = decode_step_attention.launches - before
    assert [r['rl_weight'] > 0 for r in out['history']] == [False, True]
    assert len(steps) == 2 + 2 + 4          # eval batches of both epochs, RL steps
    assert launched == cfg.num_layers * sum(steps) > 0
    assert next(out['encoder'].parameters()).device.type == 'cuda'
    restored, meta = load_checkpoint(latest_checkpoint(tmp_path / 'checkpoints'))
    assert meta['epoch'] == 1 and restored['step'] == out['state'].step == 8
    for key, module in (('enc_params', out['encoder']), ('dec_params', out['decoder'])):
        for name, v in module.state_dict().items():
            assert torch.equal(restored[key][name], v.cpu()), (key, name)
    opt = out['state'].enc_opt.state_dict()['state']
    for i, s in opt.items():
        for k, v in s.items():
            assert torch.equal(restored['enc_opt']['state'][i][k], v.cpu()), (i, k)
    assert np.isfinite([r['total'] for r in out['history']]).all()


@pytest.mark.parametrize('defaults', [False, True], ids=['tf', 'defaults'])
def test_epoch_runner_makes_the_host_wait_nowhere(cuda, defaults):
    """A teacher-forced epoch of make_epoch_runner at tiny width, without
    and with the set decoder and the round trip (TrainConfig()'s defaults,
    K1 in the rollout), runs under ``torch.cuda.set_sync_debug_mode('error')``:
    no operation in it makes the host wait for the card (a scalar copied
    from the host would); the read of its sums does, which shows that the
    mode is on."""
    import numpy as np
    from superconductor_vae_tpu_torch.data import synthetic_dataset
    from superconductor_vae_tpu_torch.models import tiny_test_config
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_epoch_runner)
    from superconductor_vae_tpu_torch.training.evaluate import _to_device
    import dataclasses
    cfg = dataclasses.replace(tiny_test_config(), pallas_decode=True)
    tc = TrainConfig(batch_size=16, max_formula_len=cfg.max_len, use_physics_z=False,
                     hungarian_enabled=defaults, use_round_trip=defaults)
    ds = synthetic_dataset(n=48, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim)
    data = _to_device(ds.batch(np.arange(len(ds))), 'cuda')
    run = make_epoch_runner(tc, build_luts(default_tokenizer(max_len=cfg.max_len), 'cuda'))
    state = create_train_state(cfg, tc, seed=0, device='cuda')
    idx = np.arange(48).reshape(3, 16)
    state, _ = run(state, data, idx[:1], 0, default_dyn(tc))        # first use
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        state, sums = run(state, data, idx, 1, default_dyn(tc))
        with pytest.raises(RuntimeError, match='synchronizing'):
            sums['total'].cpu()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert torch.isfinite(sums['total']).item()


def test_default_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One step at TrainConfig()'s defaults (the set decoder, the round
    trip with K1 in its rollout) at tiny widths with a 512-wide latent, 32
    rows (a round trip of 3), dropout off in every model, from the same
    seed on the card and on the CPU: the metrics within 1e-4 relative, the
    AdamW moments of the four groups within 1e-3 relative plus 1e-4 of
    their tree's largest; the round trip's tokens equal except in rows
    that passed a near-tie (top-two gap below 1e-4), the Hungarian
    permutations equal except where the two assignments' costs lie within
    1e-5."""
    import dataclasses
    import numpy as np
    from superconductor_vae_tpu_torch.data import synthetic_dataset
    from superconductor_vae_tpu_torch.models import SetDecoderLayer, tiny_test_config
    from superconductor_vae_tpu_torch.ops import hungarian, round_trip
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)
    from superconductor_vae_tpu_torch.training.evaluate import _to_device

    cfg = dataclasses.replace(tiny_test_config(), latent_dim=512, dropout=0.0,
                              pallas_decode=True)
    tc = TrainConfig(batch_size=32, max_formula_len=cfg.max_len)
    dyn = dict(default_dyn(tc), physz_w=1.0)
    data = synthetic_dataset(n=32, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim).batch(
        np.arange(32))
    records = {'tokens': [], 'margin': [], 'perm': [], 'cost': []}
    real_gen, real_assign = round_trip.generate_with_kv_cache, hungarian.hungarian_assignment

    def gen(*a, **k):
        out = real_gen(*a, **k)
        records['tokens'].append(out['tokens'].cpu())
        records['margin'].append(out['margin'].cpu())
        return out

    def assign(cost):
        perm, total = real_assign(cost)
        records['perm'].append(perm.cpu())
        records['cost'].append(cost.detach().cpu())
        return perm, total
    monkeypatch.setattr(round_trip, 'generate_with_kv_cache', gen)
    monkeypatch.setattr(hungarian, 'hungarian_assignment', assign)
    runs = []
    for dev in (cuda, torch.device('cpu')):
        state = create_train_state(cfg, tc, seed=0, device=dev)
        for m in state.set_decoder.modules():
            if isinstance(m, SetDecoderLayer):
                m.dropout = 0.0
        step = make_train_step(tc, build_luts(default_tokenizer(max_len=cfg.max_len), dev))
        before = decode_step_attention.launches
        state, m = step(state, _to_device(data, dev), 0, dyn)
        if dev.type == 'cuda':
            assert decode_step_attention.launches - before == cfg.num_layers * (cfg.max_len - 1)
        moments = [{i: opt.state[p]['exp_avg'].cpu() for i, p in enumerate(params)}
                   for params, opt in state.groups()]
        runs.append(({k: x.item() for k, x in m.items()}, moments))
    (m_c, mom_c), (m_h, mom_h) = runs
    assert set(m_c) == set(m_h) >= {'a5_z_mse', 'hungarian_loss', 'set_exact'}
    for key, want in m_h.items():
        assert m_c[key] == pytest.approx(want, rel=1e-4, abs=1e-6), key
    assert len(mom_c) == len(mom_h) == 4
    for got, want in zip(mom_c, mom_h):
        scale = max(w.abs().max().item() for w in want.values())
        for i, w in want.items():
            assert ((got[i] - w).abs() <= 1e-3 * w.abs() + 1e-4 * scale).all(), i
    tok_c, tok_h = records['tokens']
    assert tok_c.shape[0] == 3
    parted = (tok_c != tok_h).any(dim=1)
    near = (torch.minimum(*records['margin']) < 1e-4).any(dim=1)
    assert not (parted & ~near).any()
    (perm_c, perm_h), cost = records['perm'], records['cost'][1]
    differ = (perm_c != perm_h).any(dim=1)
    rows = torch.arange(cost.shape[1])
    for r in torch.nonzero(differ)[:, 0].tolist():
        a, b = cost[r, rows, perm_c[r]].sum(), cost[r, rows, perm_h[r]].sum()
        assert abs(a - b) <= 1e-5, (r, a, b)


def test_bench_spec_probe_on_the_card(cuda):
    """The bench's --spec probe at the quick model on the card: the
    speculative streams (plain attention, on the twin of the state's
    decoder) equal the plain greedy scan's through K1 up to each row's EOS,
    and the self-consistent draft is accepted."""
    from superconductor_vae_tpu_torch import bench
    s = bench.build(quick=True, device='cuda')
    before = decode_step_attention.launches
    r = bench.spec_probe(s, calls=1)
    assert decode_step_attention.launches > before            # the plain side's K1
    assert r['rows_equal'] == 1.0 and r['acceptance_rate'] > 0         # float32
    assert r['n_iterations'] < r['plain_steps']


def test_soft_token_passes_share_dropout_masks_on_the_card(cuda):
    """The card's generator is replayed for the second soft-token pass: in
    train mode at ratio 0 the soft-token forward equals one teacher-forced
    forward from the same seed, bit for bit, and leaves the card's stream
    where that forward leaves it."""
    import dataclasses
    from superconductor_vae_tpu_torch.models import FormulaDecoder, init_params, tiny_test_config
    from superconductor_vae_tpu_torch.training.soft_token import soft_token_forward
    cfg = dataclasses.replace(tiny_test_config(), dropout=0.3)
    dec = init_params(FormulaDecoder(cfg, device=cuda), torch.Generator().manual_seed(0))
    dec.train()
    g = torch.Generator(device=cuda).manual_seed(1)
    args = (torch.randn(4, cfg.latent_dim, generator=g, device=cuda),
            torch.randint(0, cfg.vocab_size, (4, cfg.max_len), generator=g, device=cuda),
            torch.randn(4, cfg.stoich_input_dim, generator=g, device=cuda),
            torch.randn(4, cfg.heads_input_dim, generator=g, device=cuda))
    with torch.no_grad():
        torch.manual_seed(7)
        tf = dec(*args)
        after = torch.cuda.get_rng_state(cuda)
        torch.manual_seed(7)
        soft = soft_token_forward(dec, *args, 0.0)
    assert torch.equal(torch.cuda.get_rng_state(cuda), after)
    for k in ('logits', 'stop_logits', 'type_logits', 'site_dup_logits'):
        assert torch.equal(soft[k], tf[k]), k
