"""Tensor parallelism in the port (parallel/mesh.py, parallel/tensor.py,
the decoder built on a grid, the train step over a (data, model) grid) on
gloo ranks on the CPU, through scripts/dryrun_multichip.py ``run_tp``
(rank 0 also runs the one-process step from the gathered state).

``tiny_test_config`` with a 512-wide latent (the dryrun's), dropout 0 in
every model but where a case says otherwise; the global batch is
tests/test_torch_port_distributed.py's 8 rows.
- The rules: ``tp_param_specs`` equals JAX's ``tp_param_specs`` leaf for
  leaf on the encoder and the decoder (flax kernel axis 1 is torch's dim
  0), at 2, 3 and 4 model ranks, and the tensor-parallel decoder shards
  exactly those parameters.
- ``shard_params_tp`` then ``gather_params_tp`` is the identity on a port
  checkpoint's state, a state under gradient accumulation and a decoder
  converted from JAX's parameters; ``check_equal_across`` raises on every
  rank when the ranks' tokens differ.
- At 2 ranks (a 1 x 2 grid), two steps at ``TrainConfig()``'s defaults
  (the set decoder, the round trip, physics-Z at weight 1) and two with
  the clip engaged, each against the one-process step from the same
  state: metrics within 1e-5 relative (the gradient norm 1e-4), moments
  within 1e-5 of each group's largest, the replicated parameters and
  their gradients equal across the model group bit for bit; one step with
  dropout 0.1 keeps them equal too; greedy ``eval_batch`` through the TP
  decoder gives the one-process decoder's streams.
- At 4 ranks (2 x 2), the step and the epoch runner against JAX's step
  on a (2, 2) CPU mesh with JAX's ``shard_params_tp``: ``total`` within
  2e-4, as ``__graft_entry__.dryrun_multichip`` holds it.
- ``dryrun_multichip 4`` runs and reports its TP arm.
"""

import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.ops.physics_z_loss import init_magpie_proj as jax_init_proj
from superconductor_vae_tpu.parallel import make_mesh
from superconductor_vae_tpu.parallel import shard_batch as jax_shard_batch
from superconductor_vae_tpu.parallel import shard_params_tp as jax_shard_params_tp
from superconductor_vae_tpu.parallel.mesh import tp_param_specs as jax_tp_param_specs
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import train_step as jts
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.checkpoint import (load_checkpoint, params_from_jax,
                                                     save_checkpoint)
from superconductor_vae_tpu_torch.generation import GenerationConfig
from superconductor_vae_tpu_torch.models import FormulaDecoder, tiny_test_config
from superconductor_vae_tpu_torch.parallel import tp_param_specs
from superconductor_vae_tpu_torch.parallel.tensor import tp_sharded
from superconductor_vae_tpu_torch.scripts import dryrun_multichip
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import (
    TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)
import torch_port_dist_worker as worker
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_distributed import CFG, DP_TOL, _defaults_state, _global_batch
from test_torch_port_train_step import MET_TOL, TCFG, _port_state, _to_torch
from torch_port_common import jax_config, param_trees

ROOT = Path(__file__).resolve().parent.parent
MOMENT_TOL = 1e-5
TIMEOUT = 240                      # a spawned job that hangs fails its test
CASES = ('defaults', 'clip', 'dropout')
CLIP = 0.05                        # below the clip case's gradient norm (about 100)


def _jax_leaf_dim(path, spec):
    """JAX's spec of a leaf as the dimension of torch's layout."""
    leaf = path[-1]
    if all(a is None for a in spec):
        return None
    if leaf == 'kernel':
        return 0 if spec == P(None, 'model') else 1
    return 0


def _jax_specs(tree, n_model):
    specs = jax_tp_param_specs(tree, n_model)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    leaf_name = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight',
                 'embedding': 'weight', 'query': 'query'}
    out = {}
    for path, spec in flat:
        names = [k.key for k in path]
        if names[0] == 'params':
            names = names[1:]
        out['.'.join(names[:-1] + [leaf_name[names[-1]]])] = _jax_leaf_dim(names, spec)
    return out


@pytest.mark.parametrize('n_model', [2, 3, 4])
def test_tp_param_specs_match_jax(n_model):
    """The rules leaf for leaf against JAX's on the encoder and the
    decoder, and the tensor-parallel decoder shards what they name."""
    enc_np, dec_np = param_trees(CFG, seed=0)
    encoder, decoder = params_from_jax(enc_np, dec_np, CFG, device='cpu')
    for port, tree in ((encoder, enc_np), (decoder, dec_np)):
        got, want = tp_param_specs(port, n_model), _jax_specs(tree, n_model)
        assert got == want
    dec = tp_param_specs(decoder, n_model)
    assert tp_param_specs(encoder, n_model)['element_encoder.element_embed.weight'] is None
    assert all(d is None for k, d in dec.items() if 'norm' in k or '_ln' in k)
    assert dec['token_embedding.weight'] == 0           # 4,752 divides by 2, 3 and 4
    sharded = {k: d for k, d in dec.items() if d is not None}
    if n_model != 3:          # d_model 32 and ffn 64 do not divide by 3
        assert len(sharded) >= 4
        assert dec['layer_0.self_q.weight'] == 0 and dec['layer_0.ff2.weight'] == 1
        assert dec['layer_0.self_q.bias'] == 0 and dec['layer_0.ff2.bias'] is None
    grid = types.SimpleNamespace(n_model=n_model, model_index=n_model - 1, model_group=None)
    tp = FormulaDecoder(CFG, device='cpu', tp=grid)
    assert tp_sharded(tp) == sharded
    assert tp.local_heads == (CFG.nhead // n_model if n_model != 3 else CFG.nhead)


def _light_jax_state():
    enc_np, dec_np = param_trees(CFG, seed=0)
    pz_np = jax.tree.map(np.asarray, jax_init_proj(jax.random.PRNGKey(3), CFG.magpie_dim))
    jtc = JaxTrainConfig(**TCFG)
    tx_enc, tx_dec = jts.make_optimizer(jtc), jts.make_optimizer(jtc)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), enc_params=enc_np, dec_params=dec_np,
        enc_opt=tx_enc.init(enc_np), dec_opt=tx_dec.init(dec_np),
        pz_params=pz_np, pz_opt=tx_enc.init(pz_np))
    return jstate, jtc, tx_enc, tx_dec


def _round_trip_job(tmp):
    """A port checkpoint after one step, a state under accumulation after
    one mini-step, a decoder converted from JAX's parameters."""
    luts = build_luts(default_tokenizer(max_len=CFG.max_len), device='cpu')
    batch = _to_torch(_global_batch())
    tc = TrainConfig()
    state = create_train_state(CFG, tc, seed=1, device='cpu')
    state, _ = make_train_step(tc, luts)(state, batch, 0, dict(default_dyn(tc), physz_w=1.0))
    save_checkpoint(tmp, state, CFG, tc, epoch=0, tag='ckpt')
    tc_acc = TrainConfig(**dict(TCFG, accumulation_steps=2))
    acc = create_train_state(CFG, tc_acc, seed=2, device='cpu')
    acc, _ = make_train_step(tc_acc, luts)(acc, batch, 0, default_dyn(tc_acc))
    assert acc.dec_opt.mini_step == 1
    enc_np, dec_np = param_trees(CFG, seed=4)
    torch.save({'mcfg': CFG, 'tcfg': tc, 'accum_state': acc,
                'converted': params_from_jax(enc_np, dec_np, CFG, device='cpu')[1]},
               tmp / 'inputs.pt')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The TP steps at 2 ranks (1 x 2) with a greedy decode and at 4 ranks
    (2 x 2), the round trips at 2 ranks, the dryrun CLI at 4 ranks, and,
    while they run, JAX's step on a (2, 2) mesh."""
    batch_np = _global_batch()
    batch = _to_torch(batch_np)
    second = _to_torch({k: v[::-1].copy() for k, v in batch_np.items()})
    # the rollouts through K1's wrapper (its plain version on the CPU)
    defaults, tc = _defaults_state(dataclasses.replace(CFG, pallas_decode=True))
    cases = [dryrun_multichip.dp_case(defaults, tc, dict(default_dyn(tc), physz_w=1.0))]
    tc_clip = TrainConfig(**dict(TCFG, grad_clip=CLIP))
    clip_state = create_train_state(CFG, tc_clip, seed=3, device='cpu')
    cases.append(dryrun_multichip.dp_case(clip_state, tc_clip, default_dyn(tc_clip)))
    cfg_drop = dataclasses.replace(CFG, dropout=0.1)
    drop_state = create_train_state(cfg_drop, tc_clip, seed=3, device='cpu')
    cases.append(dryrun_multichip.dp_case(drop_state, tc_clip, default_dyn(tc_clip), steps=1))
    decode = dict(case=0, batch=batch, type_masks=True, dtypes=(torch.float32, torch.bfloat16),
                  gcfg=GenerationConfig(max_len=CFG.max_len, temperature=0.0,
                                        use_type_masking=True, early_exit=True))
    job = dict(batches=[batch, second], max_len=CFG.max_len, seed=0, snapshots=False)
    tp2 = dryrun_multichip.start_tp(dict(job, cases=cases, decode=decode), 2, timeout=TIMEOUT)

    jstate, jtc, tx_enc, tx_dec = _light_jax_state()
    light = _port_state(jax.tree.map(np.asarray, jstate), CFG, TrainConfig(**TCFG))
    tp4 = dryrun_multichip.start_tp(dict(job, batches=[batch], cases=[dryrun_multichip.dp_case(
        light, TrainConfig(**TCFG), dict(default_dyn(TrainConfig(**TCFG)), physz_w=1.0),
        paths=('step', 'runner'))]), 4,
        timeout=TIMEOUT)

    rt_dir = tmp_path_factory.mktemp('tp_round_trip')
    _round_trip_job(rt_dir)
    rt = dryrun_multichip.spawn(worker.tp_round_trip, 2, rt_dir, timeout=TIMEOUT)
    cli = subprocess.Popen(
        [sys.executable, '-m', 'superconductor_vae_tpu_torch.scripts.dryrun_multichip', '4'],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # JAX's step with JAX's TP shardings on a (2, 2) CPU mesh
    mesh = make_mesh(n_data=2, n_model=2)
    jcfg = jax_config(CFG)
    jstep = jts.make_train_step(JaxEncoder(jcfg), JaxDecoder(jcfg), jtc, tx_enc, tx_dec,
                                jts.build_luts(jax_tokenizer(max_len=CFG.max_len)),
                                donate=False)
    jdyn = dict(jts.default_dyn(jtc), physz_w=jnp.asarray(1.0, jnp.float32))
    tp_state = jstate.replace(enc_params=jax_shard_params_tp(jstate.enc_params, mesh),
                              dec_params=jax_shard_params_tp(jstate.dec_params, mesh))
    _, jmetrics = jstep(tp_state, jax_shard_batch(batch_np, mesh), jax.random.PRNGKey(0), jdyn)
    jax_metrics = jax.tree.map(np.asarray, jmetrics)

    out = dict(tp2=tp2(), tp4=tp4(), jax=jax_metrics, rt_dir=rt_dir)
    rt()
    out['rt'] = [torch.load(rt_dir / f'rank{r}.pt', weights_only=False) for r in (0, 1)]
    try:
        out['cli'] = (cli.communicate(timeout=TIMEOUT)[0], cli.returncode)
    finally:
        cli.kill()
    return out


def _steps(runs, key, case, rank=0):
    return runs[key][rank]['cases'][CASES.index(case) if key == 'tp2' else 0]['step']


@pytest.mark.parametrize('case,step', [(c, s) for c in ('defaults', 'clip') for s in (0, 1)])
def test_tp_step_matches_the_one_process_step(runs, case, step):
    rec = _steps(runs, 'tp2', case)['steps'][step]
    want, got = rec['want'], rec['metrics']
    assert set(got) == set(want)
    if case == 'defaults':
        assert {'a5_z_mse', 'hungarian_loss', 'physics_z_loss'} <= set(want)
    else:
        assert want['grad_norm'] > 10 * CLIP          # the clip engaged
    for key, w in want.items():
        tol = MET_TOL if key == 'grad_norm' else DP_TOL
        np.testing.assert_allclose(got[key], w, **tol, err_msg=key)
    assert max(rec['moments_worst'].values()) <= MOMENT_TOL, rec['moments_worst']
    for rank in (0, 1):
        other = _steps(runs, 'tp2', case, rank)
        assert other['steps'][step]['replicated_equal']
        assert other['steps'][step]['metrics'] == got
        assert other['same_as_rank0'] and other['n_sharded'] == 38
    tol = dict(rtol=1e-4, atol=1e-6)
    dryrun_multichip.check_tp(runs['tp2'], tol, tol, 1e-4, 'tp2')


def test_tp_step_on_a_2x2_grid_matches_jax(runs):
    """The light case (no set decoder or round trip) at 4 ranks: the total
    within JAX's dryrun tolerance of JAX's own TP step, every metric within
    the JAX parity tests' tolerance, and the one-process step's as at 2
    ranks."""
    res = _steps(runs, 'tp4', None)
    rec = res['steps'][0]
    np.testing.assert_allclose(rec['metrics']['total'], runs['jax']['total'],
                               rtol=2e-4, atol=2e-4)
    for key, w in runs['jax'].items():
        np.testing.assert_allclose(rec['metrics'][key], w, **MET_TOL, err_msg=key)
    assert [r['grid'] for r in runs['tp4']] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert rec['rows'] == 4 and all(r['cases'][0][path]['steps'][0]['replicated_equal']
                                    for r in runs['tp4'] for path in ('step', 'runner'))
    runner = runs['tp4'][0]['cases'][0]['runner']['steps'][0]['metrics']
    np.testing.assert_allclose(runner['total'], runs['jax']['total'], rtol=2e-4, atol=2e-4)
    dryrun_multichip.check_tp(runs['tp4'], DP_TOL, MET_TOL, MOMENT_TOL, 'tp4')


@pytest.mark.parametrize('dtype', ['', ' bfloat16'])
def test_tp_greedy_decoding_matches_one_process(runs, dtype):
    """``eval_batch`` with the type-mask gate and early exit through the
    TP decoder (its caches on 2 of the 4 heads, K1's wrapper) and the whole
    one, in float32 and in bf16 compute (the parallel layers' weights cast
    once for the rollout): the same streams, but in bf16 where the top two
    logits were within a bf16 near-tie (2**-4, the bench phase's gap)."""
    dec = runs['tp2'][0]['decode']
    tp, one = dec['tp' + dtype], dec['one' + dtype]
    assert (one['generated'] != 0).any()
    assert torch.equal(runs['tp2'][1]['decode']['tp' + dtype]['generated'], tp['generated'])
    if not dtype:
        for key in ('generated', 'tf_pred'):
            assert torch.equal(tp[key], one[key]), key
        torch.testing.assert_close(tp['margin'], one['margin'], rtol=1e-4, atol=1e-5)
        return
    diff = (tp['generated'] != one['generated'])
    for r in diff.any(dim=1).nonzero()[:, 0].tolist():
        s = int(diff[r].int().argmax())
        assert min(tp['margin'][r, s], one['margin'][r, s]) < 2 ** -4, (r, s)
    assert (tp['tf_pred'] == one['tf_pred']).float().mean() > 0.95


def test_tp_dropout_keeps_the_replicas_equal(runs):
    """One step with dropout 0.1 in the decoder: the replicated parameters
    and their gradients stay equal across the model group, and the shards'
    masks are the one process's on the CPU (slices of one draw)."""
    rec = _steps(runs, 'tp2', 'dropout')['steps'][0]
    assert all(_steps(runs, 'tp2', 'dropout', r)['steps'][0]['replicated_equal']
               for r in (0, 1))
    clip = _steps(runs, 'tp2', 'clip')['steps'][0]
    assert rec['want']['total'] != clip['want']['total']   # dropout ran
    for key, w in rec['want'].items():
        tol = MET_TOL if key == 'grad_norm' else DP_TOL
        np.testing.assert_allclose(rec['metrics'][key], w, **tol, err_msg=key)


@pytest.mark.parametrize('what', ['checkpoint', 'accumulation'])
def test_shard_then_gather_is_the_identity(runs, what):
    for rank, res in enumerate(runs['rt']):
        assert res[what] and res[f'{what} sharded'] == 38 and res[f'{what} smaller'], (rank, res)
        assert res['from_jax']
    again, _ = load_checkpoint(runs['rt_dir'] / 'again')
    first, _ = load_checkpoint(runs['rt_dir'] / 'ckpt')
    assert again['dec_params'].keys() == first['dec_params'].keys()
    for k, v in first['dec_params'].items():
        assert torch.equal(again['dec_params'][k], v), k


def test_unequal_tokens_raise_on_every_rank(runs):
    for res in runs['rt']:
        assert 'unequal tokens differ across the model group' in res['raised'], res['raised']


def test_dryrun_multichip_four_ranks_tp_arm(runs):
    out, rc = runs['cli']
    assert rc == 0, out
    assert 'dryrun_multichip(4, gloo): OK' in out
    assert 'TP arm on a 2 x 2 grid matches' in out and '38 sharded decoder parameters' in out
