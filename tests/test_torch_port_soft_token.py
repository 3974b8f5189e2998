"""Soft-token scheduled sampling in the port against the JAX package
(training/soft_token.py): the ratio schedules, ``mix_embeddings``, the
two-pass ``soft_token_forward`` with its gradients, one soft-token train
step through ``make_train_step``, and ``train()``'s ratio per epoch.

Tiny widths, the same numpy weights on both sides.  Schedules and the
mixer are exact; the forward's heads and gradients agree within 1e-5
relative (float32, other summation orders), with a floor of 1e-5 of the
largest magnitude in the tensor (heads) or in the whole gradient (some
gradients, such as the cross-attention key biases', are zero but for
float32 noise); the train step meets the tolerances of
tests/test_torch_port_train_step.py.  In train mode the port's second
pass draws the first pass's dropout masks (JAX hands both passes one
``rngs``), which ``test_dropout_masks_are_shared_by_the_two_passes`` pins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.ops.physics_z_loss import init_magpie_proj as jax_init_proj
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import soft_token as jax_soft
from superconductor_vae_tpu.training import train_step as jts
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
import superconductor_vae_tpu_torch.training.train_loop as loop_mod
from superconductor_vae_tpu_torch.data import synthetic_dataset
from superconductor_vae_tpu_torch.models import FormulaDecoder, tiny_test_config
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    TrainConfig, build_luts, default_dyn, make_train_step, train)
from superconductor_vae_tpu_torch.training.soft_token import (
    SoftTokenSchedule, mix_embeddings, soft_token_forward, soft_token_ratio)
from test_torch_port_train_step import (
    MET_TOL, TCFG, _TINY, _batches, _leaves, _port_moments, _port_params, _port_state,
    _to_torch, check_moments_and_updates)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import jax_config, param_trees, port_models

CFG = tiny_test_config()
RTOL = 1e-5
HEADS = ('logits', 'stop_logits', 'type_logits', 'site_dup_logits')
SOFT_RATIO = 0.3


def assert_close(got, want, what='', scale=None):
    """1e-5 relative, with a floor of 1e-5 of ``scale`` (default: the
    largest magnitude of ``want``)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


# -- the schedule and the mixer ----------------------------------------------

@pytest.mark.parametrize('schedule', ['linear', 'cosine', 'exponential'])
@pytest.mark.parametrize('warmup', [0, 3])
def test_ratio_schedules_match_jax(schedule, warmup):
    kw = dict(n_epochs=12, start_ratio=0.05, end_ratio=0.4, warmup_epochs=warmup,
              schedule=schedule)
    got = [soft_token_ratio(e, SoftTokenSchedule(**kw)) for e in range(15)]
    want = [jax_soft.soft_token_ratio(e, jax_soft.SoftTokenSchedule(**kw)) for e in range(15)]
    assert got == want
    assert got[0] == 0.05 and got[-1] == pytest.approx(0.4)
    assert dataclasses.asdict(SoftTokenSchedule()) == dataclasses.asdict(
        jax_soft.SoftTokenSchedule())


def test_unknown_schedule_raises_as_jax():
    cfg = dict(schedule='sawtooth', warmup_epochs=0)
    with pytest.raises(ValueError) as got:
        soft_token_ratio(1, SoftTokenSchedule(**cfg))
    with pytest.raises(ValueError) as want:
        jax_soft.soft_token_ratio(1, jax_soft.SoftTokenSchedule(**cfg))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('masked', [False, True])
def test_mix_embeddings_matches_jax(dtype, masked):
    rng = np.random.default_rng(0)
    hard, soft = (rng.standard_normal((3, 7, 16)).astype(np.float32) for _ in range(2))
    mask = rng.random((3, 7)) < 0.5 if masked else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for r in (0.0, SOFT_RATIO, 1.0, 0.7):
        want = jax_soft.mix_embeddings(jnp.asarray(hard, jdt), jnp.asarray(soft, jdt), r,
                                       None if mask is None else jnp.asarray(mask))
        got = mix_embeddings(torch.tensor(hard).to(tdt), torch.tensor(soft).to(tdt), r,
                             None if mask is None else torch.tensor(mask))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        if masked:                       # the unmasked positions mix hard with itself
            keep = ~mask
            h = torch.tensor(hard).to(tdt)
            np.testing.assert_array_equal(got.float().numpy()[keep],
                                          mix_embeddings(h, h, r).float().numpy()[keep])


# -- the two-pass forward -----------------------------------------------------

@pytest.fixture(scope='module')
def forward_setup():
    trees = param_trees(CFG, seed=3)
    rng = np.random.default_rng(8)
    b = 4
    z = rng.standard_normal((b, CFG.latent_dim)).astype(np.float32)
    tokens = rng.integers(0, CFG.vocab_size, (b, CFG.max_len)).astype(np.int32)
    stoich = rng.standard_normal((b, CFG.stoich_input_dim)).astype(np.float32)
    hv = rng.standard_normal((b, CFG.heads_input_dim)).astype(np.float32)
    w = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ('logits', (b, CFG.max_len - 1, CFG.vocab_size)), ('stop_logits', (b, CFG.max_len - 1)),
        ('type_logits', (b, CFG.max_len - 1, 5)), ('site_dup_logits', (b, CFG.max_len - 1)))}
    jdec = JaxDecoder(jax_config(CFG))

    def jloss(params, zz, ratio):
        out = jax_soft.soft_token_forward(jdec, params, zz, tokens, stoich, hv, ratio)
        return sum(jnp.sum(out[k] * w[k]) for k in HEADS), out
    # one compile for every ratio (a traced scalar, as in the JAX step)
    grad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    return trees, (z, tokens, stoich, hv), w, grad


@pytest.mark.parametrize('ratio', [0.0, SOFT_RATIO, 1.0])
def test_soft_token_forward_and_gradients_match_jax(forward_setup, ratio):
    """The heads of the second pass, and the gradients of a weighted sum of
    them with respect to every decoder parameter and to z."""
    trees, (z, tokens, stoich, hv), w, grad = forward_setup
    (_, want), (g_params, g_z) = grad(trees[1], z, jnp.asarray(ratio, jnp.float32))

    _, dec = port_models(CFG, trees)
    dec.eval()
    zt = torch.tensor(z, requires_grad=True)
    got = soft_token_forward(dec, zt, torch.tensor(tokens).long(), torch.tensor(stoich),
                             torch.tensor(hv), ratio)
    sum((got[k] * torch.tensor(w[k])).sum() for k in HEADS).backward()

    for k in HEADS:
        assert_close(got[k].detach().numpy(), want[k], k)
    assert_close(zt.grad.numpy(), g_z, 'z')
    want_g = _leaves(g_params)
    got_g = {n: p.grad for n, p in dec.named_parameters()}
    assert set(got_g) == set(want_g)
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    for n, g in want_g.items():
        got_n = np.zeros_like(g) if got_g[n] is None else got_g[n].numpy()
        assert_close(got_n, g, n, scale=scale)
    assert float(np.abs(want_g['token_embedding.weight']).max()) > 0
    if ratio == 0.0:         # the teacher-forced forward
        with torch.no_grad():
            tf = dec(torch.tensor(z), torch.tensor(tokens).long(), torch.tensor(stoich),
                     torch.tensor(hv))
        assert_close(got['logits'].detach().numpy(), tf['logits'].numpy())


def test_bos_position_stays_hard(forward_setup):
    """At ratio 1 the first position still sees the BOS embedding, so its
    logits equal the teacher-forced forward's."""
    trees, (z, tokens, stoich, hv), _, _ = forward_setup
    _, dec = port_models(CFG, trees)
    args = (torch.tensor(z), torch.tensor(tokens).long(), torch.tensor(stoich), torch.tensor(hv))
    with torch.no_grad():
        soft = soft_token_forward(dec.eval(), *args, 1.0)
        tf = dec(*args)
    assert torch.equal(soft['logits'][:, 0], tf['logits'][:, 0])
    assert not torch.allclose(soft['logits'][:, 1:], tf['logits'][:, 1:])


def test_dropout_masks_are_shared_by_the_two_passes(forward_setup):
    """In train mode, at ratio 0 the second pass's input equals the first's,
    so with the first pass's masks it gives the same output as one
    teacher-forced forward from the same generator state, bit for bit; the
    generator ends where one forward leaves it."""
    trees, (z, tokens, stoich, hv), _, _ = forward_setup
    cfg = dataclasses.replace(CFG, dropout=0.3)
    _, dec = port_models(cfg, trees)
    dec.train()
    args = (torch.tensor(z), torch.tensor(tokens).long(), torch.tensor(stoich), torch.tensor(hv))
    torch.manual_seed(11)
    with torch.no_grad():
        tf = dec(*args)
    after_tf = torch.get_rng_state()
    torch.manual_seed(11)
    with torch.no_grad():
        soft = soft_token_forward(dec, *args, 0.0)
    assert torch.equal(torch.get_rng_state(), after_tf)
    for k in HEADS:
        assert torch.equal(soft[k], tf[k]), k
    torch.manual_seed(12)
    with torch.no_grad():
        other = dec(*args)
    assert not torch.equal(other['logits'], tf['logits'])       # the masks matter


# -- the train step and the loop ---------------------------------------------

def test_soft_token_train_step_matches_jax():
    """One step of the port's ``make_train_step`` with soft tokens on at
    ratio 0.3 from JAX's state S0, against JAX's step: every metric, the
    AdamW moments and the parameter changes, as
    tests/test_torch_port_train_step.py holds the default step (physics-Z
    with the learnable projection, dropout 0)."""
    cfg = _TINY
    enc_np, dec_np = param_trees(cfg, seed=0)
    pz_np = jax.tree.map(np.asarray, jax_init_proj(jax.random.PRNGKey(3), cfg.magpie_dim))
    bt = _batches(cfg)[0]
    kw = dict(TCFG, soft_token_enabled=True)
    jtc = JaxTrainConfig(**kw)
    tx_enc, tx_dec = jts.make_optimizer(jtc), jts.make_optimizer(jtc)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), enc_params=enc_np, dec_params=dec_np,
        enc_opt=tx_enc.init(enc_np), dec_opt=tx_dec.init(dec_np),
        pz_params=pz_np, pz_opt=tx_enc.init(pz_np))
    jcfg = jax_config(cfg)
    step = jts.make_train_step(JaxEncoder(jcfg), JaxDecoder(jcfg), jtc, tx_enc, tx_dec,
                               jts.build_luts(jax_tokenizer(max_len=cfg.max_len)),
                               donate=False)
    dyn = dict(jts.default_dyn(jtc), physz_w=jnp.asarray(1.0, jnp.float32),
               soft_ratio=jnp.asarray(SOFT_RATIO, jnp.float32))
    s0 = jax.tree.map(np.asarray, state)
    state, want = step(state, bt, jax.random.PRNGKey(0), dyn)
    s1, want = jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, want)

    tc = TrainConfig(**kw)
    pstate = _port_state(s0, cfg, tc)
    before = _port_params(pstate)
    pstep = make_train_step(tc, build_luts(default_tokenizer(max_len=cfg.max_len), 'cpu'))
    pdyn = dict(default_dyn(tc), physz_w=1.0, soft_ratio=SOFT_RATIO)
    pstate, got = pstep(pstate, _to_torch(bt), 0, pdyn)
    got = {k: v.item() for k, v in got.items()}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **MET_TOL, err_msg=key)
    check_moments_and_updates(before, _port_params(pstate), _port_moments(pstate), s0, s1,
                              tc.learning_rate, tc.weight_decay, 1)
    # the soft tokens change the step: the same step at ratio 0 differs
    pstate0 = _port_state(s0, cfg, tc)
    _, at0 = pstep(pstate0, _to_torch(bt), 0, dict(pdyn, soft_ratio=0.0))
    assert at0['formula_loss'].item() != got['formula_loss']


def test_train_sets_the_ratio_per_epoch(tmp_path, monkeypatch):
    """``train()`` with soft tokens: each epoch's steps get the schedule's
    ratio for that epoch (JAX's ``soft_token_ratio``), warm-up included."""
    kw = dict(batch_size=16, max_formula_len=16, use_physics_z=False,
              hungarian_enabled=False, use_round_trip=False, num_epochs=4,
              eval_interval=10, soft_token_enabled=True, soft_token_start_ratio=0.1,
              soft_token_end_ratio=0.3, soft_token_warmup_epochs=1, soft_token_epochs=3,
              soft_token_schedule='cosine')
    seen = []
    real = loop_mod.make_epoch_runner

    def recording(*args, **kwargs):
        run = real(*args, **kwargs)

        def wrapped(state, data, idx_mat, seed, dyn):
            seen.append(dyn['soft_ratio'])
            return run(state, data, idx_mat, seed, dyn)
        return wrapped
    monkeypatch.setattr(loop_mod, 'make_epoch_runner', recording)
    out = train(model_config=CFG, train_config=TrainConfig(**kw),
                dataset=synthetic_dataset(n=32, max_len=16, magpie_dim=16),
                output_dir=tmp_path, log_fn=lambda *a: None, device='cpu')
    sched = jax_soft.SoftTokenSchedule(n_epochs=3, start_ratio=0.1, end_ratio=0.3,
                                       warmup_epochs=1, schedule='cosine')
    assert seen == [jax_soft.soft_token_ratio(e, sched) for e in range(4)]
    assert seen[0] == seen[1] == 0.1 and seen[-1] == pytest.approx(0.3)
    assert len(out['history']) == 4
    assert all(np.isfinite(r['total']) for r in out['history'])


@pytest.mark.parametrize('entry', [lambda: FormulaDecoder(CFG).embed_soft])
def test_cuda_default_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry()
