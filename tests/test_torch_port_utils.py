"""The utilities of the port (utils/profiling.py, utils/debug.py,
utils/env_config.py) and the Magpie bridge in ``load_dataset``:
- ``load_dataset(magpie_bridge=...)`` gives the JAX loader's arrays bit
  for bit (the corpus, the repo's bridge);
- ``train(debug_numerics=True)`` trains one dispatch a step (the epoch
  runner is not called) and removes its checks afterwards; a NaN put into
  a decoder weight raises ``FloatingPointError`` naming the op and the
  module; ``checkify_fn`` names the first op that made a NaN and throws
  on the host;
- ``PhaseTimer`` and ``detect_environment`` as tests/test_misc.py holds
  JAX's; ``trace_context`` writes a trace with ``named_scope``'s region.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

import superconductor_vae_tpu_torch.training.train_loop as loop_mod
from superconductor_vae_tpu.data.pipeline import load_dataset as jax_load_dataset
from superconductor_vae_tpu_torch.data import load_dataset, synthetic_dataset
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.training import TrainConfig, train
from superconductor_vae_tpu_torch.utils.debug import checkify_fn, enable_nan_debugging
from superconductor_vae_tpu_torch.utils.env_config import detect_environment
from superconductor_vae_tpu_torch.utils.profiling import PhaseTimer, named_scope, trace_context
import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
BRIDGE = ROOT / 'data/magpie_bridge.npz'
_LOOP = dict(batch_size=16, max_formula_len=16, use_physics_z=False, hungarian_enabled=False,
             use_round_trip=False, num_epochs=1, eval_max_batches=1, debug_numerics=True)


def test_magpie_bridge_load_equals_jax():
    got = load_dataset(CSV, magpie_bridge=BRIDGE, limit=2000)
    want = jax_load_dataset(CSV, magpie_bridge=BRIDGE, limit=2000, cache_dir=None)
    assert got.magpie.shape[1] == np.load(BRIDGE)['w'].shape[1]
    for k in ('magpie', 'tokens', 'tc', 'element_fractions', 'comp_targets'):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    np.testing.assert_array_equal(got.norm_stats.magpie_mean, want.norm_stats.magpie_mean)
    assert got.norm_stats.magpie_skewed_indices == want.norm_stats.magpie_skewed_indices


def test_debug_numerics_trains_one_dispatch_a_step(tmp_path, monkeypatch):
    def no_runner(*a, **k):
        raise AssertionError('the epoch runner ran under debug_numerics')
    monkeypatch.setattr(loop_mod, 'make_epoch_runner', no_runner)
    out = train(model_config=tiny_test_config(), train_config=TrainConfig(**_LOOP),
                dataset=synthetic_dataset(n=32, max_len=16, magpie_dim=16),
                output_dir=tmp_path, log_fn=lambda *a, **k: None, device='cpu')
    assert np.isfinite(out['history'][0]['total'])
    # the checks are gone: a NaN no longer raises
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_injected_nan_raises_naming_its_module(tmp_path, monkeypatch):
    real = loop_mod.create_train_state

    def poisoned(*a, **k):
        state = real(*a, **k)
        with torch.no_grad():
            state.decoder.layer_0.ff1.weight[0, 0] = float('nan')
        return state
    monkeypatch.setattr(loop_mod, 'create_train_state', poisoned)
    with pytest.raises(FloatingPointError, match=r'op aten\.\S+ in module '
                                                 r'FormulaDecoder\.layer_0\.ff1 \(Dense\)'):
        train(model_config=tiny_test_config(), train_config=TrainConfig(**_LOOP),
              dataset=synthetic_dataset(n=32, max_len=16, magpie_dim=16),
              output_dir=tmp_path, log_fn=lambda *a, **k: None, device='cpu')
    assert not torch.is_anomaly_enabled()


def test_finite_check_on_module_outputs():
    """An output that is infinite but not NaN trips the module check."""
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.bias.fill_(float('inf'))
    dbg = enable_nan_debugging(lin)
    try:
        with pytest.raises(FloatingPointError, match=r'non-finite output of module Linear'):
            lin(torch.ones(1, 2))
    finally:
        dbg.remove()


def test_checkify_fn_names_the_first_op():
    fn = checkify_fn(lambda x: torch.sqrt(x - 2.0).sum() + torch.log(x).sum())
    err, out = fn(torch.tensor([1.0, 4.0]))
    assert torch.isnan(out)
    with pytest.raises(FloatingPointError, match=r'aten\.sqrt'):
        err.throw()
    err, out = fn(torch.tensor([3.0, 4.0]))
    assert err.get() is None and torch.isfinite(out)
    err.throw()


def test_phase_timer():
    t = PhaseTimer()
    with t.phase('a'):
        time.sleep(0.01)
    with t.phase('b', sync=torch.ones(4)):
        pass
    assert t.totals['a'] >= 0.01
    assert 'a' in t.summary() and 'b' in t.summary()
    t.reset()
    assert not t.totals


def test_env_detection(monkeypatch):
    monkeypatch.setenv('WORLD_SIZE', '3')
    env = detect_environment()
    assert env.platform in ('cpu', 'gpu')
    assert env.n_devices >= 1 and env.n_hosts == 3
    assert env.suggested_batch_size > 0
    assert env.as_overrides()['n_samples_rloo'] >= 2
    if not torch.cuda.is_available():
        assert (env.platform, env.suggested_batch_size) == ('cpu', 32)


def test_trace_context_writes_a_trace(tmp_path):
    with trace_context(str(tmp_path)) as prof:
        with named_scope('port_region'):
            torch.ones(8).sum()
    assert prof is not None
    assert any(e.key == 'port_region' for e in prof.key_averages())
    assert list(tmp_path.glob('*.json'))
