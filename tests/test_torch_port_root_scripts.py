"""The port's counterparts of the JAX repo's remaining root scripts
(superconductor_vae_tpu_torch/scripts/): each analyzer against the JAX
script on the same small generated input (stdout equal, or the JSON lines
within float rounding), ``snapshot_params`` on a tiny port checkpoint, and
the run recipes' command lines parsed by the port CLIs' own parsers,
their ``--set`` overrides into a ``TrainConfig``, without running
anything.  The JAX scripts run in this process (``runpy``), their
``sys.argv`` set.
"""

import argparse
import contextlib
import csv
import io
import json
import runpy
import shlex
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from superconductor_vae_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from superconductor_vae_tpu_torch.data import read_csv_rows
from superconductor_vae_tpu_torch.generation import GenerationConfig, generate_with_kv_cache
from superconductor_vae_tpu_torch.models import FormulaDecoder, tiny_test_config
from superconductor_vae_tpu_torch.scripts import (analyze_error_reports, analyze_training_log,
                                                  compute_topology, phase2_dashboard,
                                                  snapshot_params)
from superconductor_vae_tpu_torch.scripts import train as train_cli
from superconductor_vae_tpu_torch.training import TrainConfig, create_train_state
from superconductor_vae_tpu_torch.training.train_loop import CSV_FIELDS
import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parent.parent
JAX_SCRIPTS = ROOT / 'scripts'
PORT_SCRIPTS = ROOT / 'superconductor_vae_tpu_torch' / 'scripts'
CORPUS = ROOT / 'data' / 'processed' / 'jarvis_merged.csv.gz'


def _jax_stdout(name, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [f'{name}.py', *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(JAX_SCRIPTS / f'{name}.py'), run_name='__main__')
    return buf.getvalue()


def _port_stdout(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return buf.getvalue()


# -- analyze_error_reports ---------------------------------------------------------

def _perturb(formula: str, rng) -> str:
    """A wrong generation of ``formula``: an element swapped for another,
    one dropped, one added, the order reversed, an amount changed, or the
    formula itself."""
    from superconductor_vae_tpu_torch.data.canonical_ordering import (join_ordered,
                                                                      parse_ordered)
    parts = parse_ordered(formula)
    kind = rng.integers(6)
    if kind == 0:
        parts[0] = ('Xe' if parts[0][0] != 'Xe' else 'Kr', *parts[0][1:])
    elif kind == 1 and len(parts) > 1:
        parts = parts[:-1]
    elif kind == 2:
        parts = parts + [('Rb', '2', 2.0)]
    elif kind == 3:
        parts = parts[::-1]
    elif kind == 4:
        sym, amt, val = parts[-1]
        parts[-1] = (sym, f'{val * 1.05:.2f}'.rstrip('0').rstrip('.'), val * 1.05)
    return join_ordered(parts)


@pytest.fixture(scope='module')
def error_reports(tmp_path_factory):
    """Three reports of 40 records each, from the corpus's formulas, some
    recurring."""
    d = tmp_path_factory.mktemp('error_reports')
    rng = np.random.default_rng(0)
    formulas = read_csv_rows(CORPUS, 300)['formula']
    for e in (7, 15, 23):
        rows = rng.choice(len(formulas), 40, replace=False)
        with open(d / f'epoch_{e:05d}.jsonl', 'w') as f:
            for i in rows:
                f.write(json.dumps({
                    'epoch': e, 'index': int(i), 'formula': formulas[i],
                    'generated': _perturb(formulas[i], rng),
                    'tc_kelvin': float(rng.choice([0.5, 5.0, 30.0, 77.0, 120.0])),
                    'z_norm': float(rng.gamma(4.0)), 'family': int(rng.integers(0, 6))}) + '\n')
    return d


@pytest.mark.parametrize('flags', [[], ['--last', '--top', '5']])
def test_analyze_error_reports_matches_jax(error_reports, flags, monkeypatch):
    argv = [str(error_reports), *flags]
    want = _jax_stdout('analyze_error_reports', argv, monkeypatch)
    got = _port_stdout(analyze_error_reports, argv)
    assert 'error patterns' in got and got == want


# -- analyze_training_log -------------------------------------------------------------

@pytest.fixture(scope='module')
def training_log(tmp_path_factory):
    """A training_metrics.csv of 80 epochs with a resume that repeats
    epochs 50-54, RL from epoch 30, a collapse at 60, empty cells."""
    rng = np.random.default_rng(1)
    path = tmp_path_factory.mktemp('log') / 'training_metrics.csv'
    rows = []
    for e in list(range(55)) + list(range(50, 80)):
        exact = min(0.97, 0.02 * e + 0.01 * rng.random()) * (0.5 if e == 60 else 1.0)
        rows.append({
            'epoch': e, 'total': 5.0 * np.exp(-e / 15) + 0.01 * rng.random(),
            'formula_loss': 3.0 * np.exp(-e / 10), 'tc_loss': '' if e == 3 else 0.2 * rng.random(),
            'exact_match': exact, 'token_accuracy': min(1.0, 0.5 + exact / 2),
            'true_ar_exact': exact * 0.9, 'rl_weight': 1.0 if e >= 30 and e % 3 == 0 else 0.0,
            'physz_weight': 0.0, 'lr': 1e-4 * (1 + np.cos(np.pi * e / 80)) / 2,
            'entropy': 2.0 - 0.01 * e + 0.05 * rng.random(),
            'mean_reward': 0.1 * rng.random() if e >= 30 else 0.0,
            'epoch_time_s': round(10 + rng.random(), 3),
            'samples_per_s': round(1000 + 50 * rng.random(), 1)})
    with open(path, 'w', newline='') as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        w.writeheader()
        w.writerows(rows)
    return path


@pytest.mark.parametrize('flags', [[], ['--plateau-window', '5', '--trend-window', '10',
                                        '--table-every', '7']])
def test_analyze_training_log_matches_jax(training_log, flags, monkeypatch):
    argv = [str(training_log), *flags]
    want = _jax_stdout('analyze_training_log', argv, monkeypatch)
    got = _port_stdout(analyze_training_log, argv)
    assert 'CORRELATION WITH exact_match' in got and got == want


# -- phase2_dashboard ------------------------------------------------------------------

@pytest.mark.parametrize('with_log', [True, False])
def test_phase2_dashboard_matches_jax(tmp_path, with_log, monkeypatch):
    rng = np.random.default_rng(2)
    if with_log:
        with open(tmp_path / 'phase2_log.jsonl', 'w') as f:
            for i in range(5):
                f.write(json.dumps({
                    'epoch': 16 * (i + 1), 'phase2_weight': 0.02 * (i + 1), 'sigma': 0.5,
                    'explore_temp': 1.0 + 0.1 * i, 'phase2_loss': float(rng.random()),
                    'loss1_round_trip': float(rng.random()),
                    'loss2_consistency': float(rng.random()), 'loss3_physics': 0.0,
                    'loss4_reinforce': float(rng.random()), 'round_trip_z_mse': 0.3,
                    'n_sampled': 64, 'n_accepted': int(rng.integers(10, 60)),
                    'unique_rate': float(rng.random()), 'n_novel': 3, 'holdout_hits': 0,
                    'mode_collapsed': i == 2}) + '\n')
                if i == 1:
                    f.write('not json\n')
        (tmp_path / 'holdout_results.json').write_text(json.dumps({'summary': {
            'exact': 5, 'n_targets': 45, 'sim_ge_99': 9, 'sim_ge_95': 20,
            'mean_similarity': 0.93}}))
    with open(tmp_path / 'phase2_discoveries.jsonl', 'w') as f:
        for i in range(12):
            f.write(json.dumps({'formula': f'Ba{i + 1}Cu3O7', 'epoch': i,
                                'meta': {'epoch': i}}) + '\n')
    want = _jax_stdout('phase2_dashboard', [str(tmp_path)], monkeypatch)
    got = _port_stdout(phase2_dashboard, [str(tmp_path)])
    assert 'PHASE 2' in got and got == want


# -- compute_topology --------------------------------------------------------------------

def _cache(path, seed, n=240, d=24):
    """A latent cache: two SC clusters and a non-SC one, z stored as raw
    bf16 words as the loop's bf16 runs store it."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((3, d)) * 3
    label = rng.integers(0, 3, n)
    z = centres[label] + rng.standard_normal((n, d))
    np.savez(path, z=z.astype(ml_dtypes.bfloat16),
             is_sc=(label < 2).astype(np.int8),
             tc_kelvin=np.where(label < 2, 10 + 30 * label + rng.random(n), 0).astype(np.float32))
    return path


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


@pytest.mark.parametrize('mode', ['compact', 'full', 'longitudinal'])
def test_compute_topology_matches_jax(tmp_path, mode, monkeypatch):
    caches = [_cache(tmp_path / f'run{i}_latent_cache.npz', i) for i in range(2)]
    flags = (['--longitudinal', str(tmp_path / '*_latent_cache.npz')] if mode == 'longitudinal'
             else [str(caches[0])] + (['--full'] if mode == 'full' else []))
    want_out, got_out = tmp_path / 'jax.jsonl', tmp_path / 'port.jsonl'
    want = _jax_stdout('compute_topology', [*flags, '--k', '10', '--out', str(want_out)],
                       monkeypatch)
    got = _port_stdout(compute_topology, [*flags, '--k', '10', '--out', str(got_out)])
    if mode != 'longitudinal':
        assert 'intrinsic_dim_mle' in got and got == want
    want_l, got_l = _lines(want_out), _lines(got_out)
    assert len(got_l) == len(want_l) == (2 if mode == 'longitudinal' else 1)
    for g, w in zip(got_l, want_l):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k in ('time', 'cache'):
                continue
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-9, abs=1e-12, nan_ok=True), k
            else:
                assert g[k] == v, k


# -- snapshot_params ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    cfg = tiny_test_config()
    tc = TrainConfig(max_formula_len=cfg.max_len, use_physics_z=True)
    state = create_train_state(cfg, tc, seed=0, device='cpu')
    for params, opt in state.groups():          # moments to drop
        for p in params:
            p.grad = torch.full_like(p, 1e-3)
        opt.step()
    root = tmp_path_factory.mktemp('ckpt')
    return save_checkpoint(root, state, cfg, tc, epoch=3, tag='best'), cfg


def _greedy(decoder, cfg):
    g = torch.Generator().manual_seed(3)
    z = torch.randn(6, cfg.latent_dim, generator=g)
    stoich = torch.rand(6, cfg.stoich_input_dim, generator=g)
    heads = torch.randn(6, cfg.heads_input_dim, generator=g)
    return generate_with_kv_cache(decoder.eval(), z, stoich, heads, None,
                                  GenerationConfig(max_len=cfg.max_len, temperature=0.0))


@pytest.mark.parametrize('keep_fp32', [False, True])
def test_snapshot_params_writes_a_loadable_params_only_checkpoint(checkpoint, tmp_path,
                                                                  keep_fp32):
    src, cfg = checkpoint
    out = tmp_path / 'snap'
    note = snapshot_params.main(['--checkpoint', str(src), '--out', str(out)]
                                + (['--keep-fp32'] if keep_fp32 else []))
    assert note['params_dtype'] == ('float32' if keep_fp32 else 'bfloat16')
    snap, meta = load_checkpoint(out)
    full, full_meta = load_checkpoint(src)
    assert {k for k in full if not k.endswith('_opt')} == set(snap)
    assert 'dec_opt' in full and not any(k.endswith('_opt') for k in snap)
    assert meta['epoch'] == full_meta['epoch'] and snap['step'] == full['step']
    want_dtype = torch.float32 if keep_fp32 else torch.bfloat16
    for group in ('enc_params', 'dec_params', 'pz_params', 'set_params'):
        for k, v in snap[group].items():
            assert v.dtype == want_dtype, (group, k)
            assert torch.equal(v, full[group][k].to(want_dtype)), (group, k)
    # it decodes as the bf16-rounded source does
    dec_snap, dec_src = FormulaDecoder(cfg, device='cpu'), FormulaDecoder(cfg, device='cpu')
    dec_snap.load_state_dict(snap['dec_params'])
    dec_src.load_state_dict({k: v.to(want_dtype).float() for k, v in full['dec_params'].items()})
    got, want = _greedy(dec_snap, cfg), _greedy(dec_src, cfg)
    assert torch.equal(got['tokens'], want['tokens'])


# -- the run recipes -----------------------------------------------------------------------

RECIPES = ('launch_run4', 'launch_run5', 'launch_run5_resume', 'launch_run5_r5', 'run5_post')


def _commands(path):
    """(program, arguments) of each python command line of a shell script:
    the program is the module after ``-m`` or the script's stem."""
    text = Path(path).read_text().replace('\\\n', ' ')
    out = []
    for line in text.splitlines():
        toks = shlex.split(line, comments=True)
        if toks[:1] == ['exec']:
            toks = toks[1:]
        if not toks or toks[0] != 'python':
            continue
        toks = [t for t in toks[1:] if t != '-u']
        if toks[0] == '-m':
            out.append((toks[1].rsplit('.', 1)[-1], toks[2:]))
        else:
            out.append((Path(toks[0]).stem, toks[1:]))
    return out


class _Parsed(Exception):
    pass


def _parse_only(monkeypatch, module, argv):
    """The namespace and the leftover arguments of ``module.main(argv)``'s
    parse, which stops there."""
    def capture(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))
    real = argparse.ArgumentParser.parse_known_args
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, 'parse_known_args', capture)
        with pytest.raises(_Parsed) as e:
            module.main(argv)
    return e.value.args[0]


@pytest.mark.parametrize('recipe', RECIPES)
def test_recipe_parses_under_the_port_clis(recipe, monkeypatch):
    import importlib
    port = _commands(PORT_SCRIPTS / f'{recipe}.sh')
    jax = _commands(JAX_SCRIPTS / f'{recipe}.sh')
    assert [p for p, _ in port] == [p for p, _ in jax] and port
    for (prog, args), (_, jax_args) in zip(port, jax):
        # the JAX recipe's flags, its results directory the port's own
        assert args == [a.replace('results/run5/', '$OUT/') for a in jax_args]
        module = importlib.import_module(f'superconductor_vae_tpu_torch.scripts.{prog}')
        ns, rest = _parse_only(monkeypatch, module, args)
        if prog != 'train_resilient':
            assert rest == [], (prog, rest)
            assert ns.checkpoint == '$CKPT' and ns.csv == '$CSV'
            continue
        assert ns.stall_timeout == 1800 and rest[0] == '--'
        p = train_cli.build_parser()
        targs = p.parse_args(rest[1:])
        tcfg, mcfg = train_cli.configs(p, targs)
        assert mcfg is None and tcfg.compute_dtype == 'bfloat16'
        assert (tcfg.batch_size, tcfg.learning_rate, tcfg.checkpoint_interval,
                tcfg.resume) == (128, 1e-4, 25, 'auto')
        assert tcfg.num_epochs == int(rest[rest.index('--epochs') + 1])
        sets = [rest[i + 1] for i, a in enumerate(rest) if a == '--set']
        assert len(sets) >= 5
        for kv in sets:
            key, _, raw = kv.partition('=')
            val = getattr(tcfg, key)
            want = (raw.lower() == 'true' if isinstance(val, bool) else type(val)(raw))
            assert val == want, key
        assert tcfg.phase2_enabled and tcfg.lr_warmup_epochs == 0
