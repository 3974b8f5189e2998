"""The data-parallel and the tensor-parallel train steps on N ranks
against the one-process step (port of ``__graft_entry__.dryrun_multichip``),
and the harnesses that run those comparisons for any train state and
global batch.

The CLI spawns N ranks (gloo on the CPU; with ``--cuda`` NCCL, rank r on
``cuda:r % device_count``), builds ``tiny_test_config`` with a 512-wide
latent (the physics-Z block map's supervised width) at ``TrainConfig()``'s
defaults (the set decoder, the round trip, physics-Z on at weight 1),
dropout 0 so that the ranks' masks do not matter, and on a global batch of
2 rows a rank runs:
- the DP arm: one data-parallel step, each rank on its shard, the
  parameters replicated from rank 0;
- the epoch-runner arm: ``make_epoch_runner`` over the same batch
  gathered on the device, one iteration;
- with N >= 4 and even, the TP arm: the same step on an (N/2 x 2) grid
  (``parallel.mesh.make_grid``), the decoder Megatron-sharded on the
  model axis (``shard_params_tp``); it fails if ``tp_param_specs`` shards
  no decoder parameter (JAX's guard against a vacuous pass).
Each arm is held against the one-process step on the whole batch, run on
rank 0 from the same state: every metric and every group's AdamW moments
within 1e-4 relative (the TP arm's total also within JAX's 2e-4), every
rank's parameters rank 0's; in the TP arm the replicated parameters and
their gradients are equal across each model group, bit for bit.

    python -m superconductor_vae_tpu_torch.scripts.dryrun_multichip 4
    python -m superconductor_vae_tpu_torch.scripts.dryrun_multichip 2 --cuda

``run_dp(job, world, device)`` (``start_dp``: without waiting) runs the
same comparison for a job of train states, configs and global batches
(tests/test_torch_port_distributed.py holds its results to JAX's step;
chip_smoke.py runs it at run4 width with K1 counted); ``check_dp`` holds
its results to tolerances.  ``run_tp(job, world, device, n_model)``
(``start_tp``) and ``check_tp`` are their tensor-parallel counterparts,
which also decode a batch greedily through the TP decoder and the whole
one (tests/test_torch_port_tensor_parallel.py, chip_smoke.py's TP phase).
``spawn`` starts ranks of any function, joined through
``parallel.init_distributed``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import io
import pickle
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from superconductor_vae_tpu_torch.parallel import broadcast_, init_distributed, shard_batch

TOL = 1e-4
TP_TOTAL_TOL = 2e-4       # __graft_entry__'s rtol = atol for the TP arm's total


def spawn(fn, world: int, job_dir, device: str = 'cpu', backend=None,
          timeout: Optional[float] = None):
    """Starts ``fn(rank, world, job_dir, device)`` in ``world`` spawned
    ranks joined through a file in ``job_dir`` by ``init_distributed``
    (NCCL on CUDA and gloo on the CPU unless ``backend`` says otherwise;
    rank r on ``cuda:r % device_count``; one torch thread a rank on the
    CPU).  Returns at once a function that waits for the ranks and raises
    if one failed, or kills them and raises ``TimeoutError`` once
    ``timeout`` seconds have passed since the start (a hang fails)."""
    ctx = mp.start_processes(_entry, args=(fn, world, str(job_dir), str(device), backend),
                             nprocs=world, start_method='spawn', join=False)
    end = None if timeout is None else time.monotonic() + timeout

    def wait():
        while not ctx.join(timeout=None if end is None else 1.0):
            if end is not None and time.monotonic() > end:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f'{world} ranks of {fn.__name__} still running after '
                                   f'{timeout:g} s')
    return wait


def _entry(rank, fn, world, job_dir, device, backend):
    cuda = torch.device(device).type == 'cuda'
    if not cuda:
        torch.set_num_threads(1)
    dev = init_distributed(device, init_method=f'file://{job_dir}/rendezvous', rank=rank,
                           world_size=world,
                           local_rank=rank % torch.cuda.device_count() if cuda else 0,
                           backend=backend)
    try:
        fn(rank, world, Path(job_dir), dev)
    finally:
        dist.destroy_process_group()


def snapshot(state) -> List[list]:
    """Parameters and AdamW moments of every group, as numpy arrays (zeros
    for a parameter without moments)."""
    out = []
    for params, opt in state.groups():
        inner = getattr(opt, 'inner', opt)
        zero = {'exp_avg': torch.zeros(()), 'exp_avg_sq': torch.zeros(())}
        out.append([(p.detach().cpu().numpy().copy(),
                     *(inner.state.get(p, zero)[k].cpu().numpy().copy()
                       for k in ('exp_avg', 'exp_avg_sq'))) for p in params])
    return out


def _moments_worst(state, ref) -> Dict[str, float]:
    """Each group's largest AdamW-moment difference from ``ref``'s, of
    ``ref``'s largest moment in that group."""
    worst = {}
    for g, ((params, opt), (rparams, ropt)) in enumerate(zip(state.groups(), ref.groups())):
        got = getattr(opt, 'inner', opt).state
        want = getattr(ropt, 'inner', ropt).state
        pairs = [(got[p], want[rp]) for p, rp in zip(params, rparams)
                 if p in got and rp in want]
        for col in ('exp_avg', 'exp_avg_sq'):
            scale = max((w[col].abs().max().item() for _, w in pairs), default=0.0)
            diff = max(((a[col] - w[col]).abs().max().item() for a, w in pairs), default=0.0)
            worst[f'{g} {col}'] = diff / scale if scale > 0 else diff
    return worst


def _same_as_rank0(state, group) -> bool:
    """Whether this rank's parameters and AdamW moments are rank 0's, bit
    for bit."""
    flat = torch.cat([t.reshape(-1) for params, opt in state.groups()
                      for p in params for t in (p.detach(), *_moments(opt, p))])
    ref = flat.clone()
    broadcast_([ref], group)
    return bool(torch.equal(ref, flat))


def _moments(opt, p):
    got = getattr(opt, 'inner', opt).state.get(p)
    return (got['exp_avg'], got['exp_avg_sq']) if got else ()


def dp_case(state, tcfg, dyn, rl: bool = False, paths: Sequence[str] = ('step',),
            steps: Optional[int] = None) -> dict:
    """A case of a ``run_dp`` job: the train state (saved now), its
    ``TrainConfig``, ``dyn``, ``rl_enabled``, the paths to run it through
    ('step': ``make_train_step`` on this rank's shard; 'runner':
    ``make_epoch_runner`` over the global batch on the device) and the
    number of the job's global batches to step over (all if None)."""
    buf = io.BytesIO()
    torch.save(state, buf)
    return dict(state=buf.getvalue(), tcfg=tcfg, dyn=dyn, rl=rl, paths=tuple(paths),
                steps=steps)


def dp_steps(rank: int, world: int, job_dir: Path, device: torch.device) -> None:
    """One rank of ``run_dp``.  For each case and each of its paths, from
    the case's state, the data-parallel step over each global batch in
    turn; before each, rank 0 copies the state and, after it, runs the
    one-process step on the whole batch from the copy.  K1's launches are
    counted over the DP step alone.  Writes rank<r>.pt."""
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (build_luts, make_epoch_runner,
                                                       make_train_step)
    job = torch.load(job_dir / 'job.pt', weights_only=False)
    cuda = device.type == 'cuda'
    if cuda:
        # float32 matmuls in full float32, as the one-process step's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    group = dist.group.WORLD
    luts = build_luts(default_tokenizer(max_len=job['max_len']), device=device)
    batches = [{k: v.to(device) for k, v in b.items()} for b in job['batches']]
    seed, snapshots = job['seed'], job['snapshots']
    cases = []
    for c, case in enumerate(job['cases']):
        tcfg, dyn, rl = case['tcfg'], case['dyn'], case['rl']
        one_step = make_train_step(tcfg, luts, rl_enabled=rl)
        out = {}
        for path in case['paths']:
            state = torch.load(job_dir / f'state{c}.pt', map_location=device,
                               weights_only=False)
            if path == 'step':
                step = make_train_step(tcfg, luts, rl_enabled=rl, group=group)
            else:
                runner = make_epoch_runner(tcfg, luts, rl_enabled=rl, group=group)
                step = lambda s, b, k, d: runner(s, b, np.arange(len(b['tc']))[None],  # noqa: E731
                                                 k, d)
            steps = []
            for batch in batches[:case['steps']]:
                ref = copy.deepcopy(state) if rank == 0 else None
                shard = shard_batch(batch, group)
                sync()
                dist.barrier(group)
                decode_step_attention.launches = 0
                t0 = time.perf_counter()
                state, metrics = step(state, shard if path == 'step' else batch, seed, dyn)
                sync()
                rec = {'seconds': time.perf_counter() - t0, 'k1': decode_step_attention.launches,
                       'rows': len(shard['tc']),
                       'metrics': {k: v.item() for k, v in metrics.items()}}
                if rank == 0:
                    t0 = time.perf_counter()
                    ref, want = one_step(ref, batch, seed, dyn)
                    sync()
                    rec.update(one_seconds=time.perf_counter() - t0,
                               want={k: v.item() for k, v in want.items()},
                               moments_worst=_moments_worst(state, ref))
                    if snapshots:
                        rec['snapshot'], rec['one'] = snapshot(state), snapshot(ref)
                    del ref
                steps.append(rec)
            out[path] = {'steps': steps, 'same_as_rank0': _same_as_rank0(state, group)}
            del state
        cases.append(out)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None
    torch.save({'cases': cases, 'peak_gib': peak}, job_dir / f'rank{rank}.pt',
               pickle_protocol=pickle.HIGHEST_PROTOCOL)


def start_dp(job: dict, world: int, device: str = 'cpu', backend=None, fn=dp_steps,
             timeout: Optional[float] = None):
    """``dp_steps`` (or ``fn``) over ``job`` in ``world`` spawned ranks
    (``spawn``, with its ``timeout``); returns at once a function that
    waits for them and returns their results.

    ``job``: ``cases`` (``dp_case``), ``batches`` (global batches of CPU
    tensors), ``max_len`` (the tokenizer's, for the LUTs), ``seed`` (the
    steps' key) and ``snapshots`` (whether rank 0 returns the parameters
    and AdamW moments after each step, ``snapshot``, and after the
    one-process step, ``one``).  The results are each rank's: per case,
    per path, ``steps`` (per batch: ``metrics``, ``seconds``, ``k1``,
    ``rows``; on rank 0 also ``want``, ``one_seconds`` and
    ``moments_worst``, the one-process step's) and ``same_as_rank0`` (the
    parameters and moments after the last step, bit for bit); and
    ``peak_gib``."""
    d = Path(tempfile.mkdtemp(prefix='dryrun_multichip_'))
    # each case's saved state in a file of its own, the rest pickled
    for c, case in enumerate(job['cases']):
        (d / f'state{c}.pt').write_bytes(case['state'])
    torch.save(dict(job, cases=[{k: v for k, v in case.items() if k != 'state'}
                                for case in job['cases']]), d / 'job.pt')
    wait = spawn(fn, world, d, device, backend, timeout)

    def results() -> List[dict]:
        try:
            wait()
            return [torch.load(d / f'rank{r}.pt', weights_only=False) for r in range(world)]
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return results


def run_dp(job: dict, world: int, device: str = 'cpu', backend=None) -> List[dict]:
    """``start_dp``'s results, waited for."""
    return start_dp(job, world, device, backend)()


def check_dp(ranks: List[dict], tol: dict, grad_norm_tol: dict, moment_tol: float,
             what: str) -> float:
    """Raises unless, in every case, path and step, each metric of rank 0 is
    within ``tol`` (``rtol``, ``atol``) of the one-process step's (the
    gradient norm within ``grad_norm_tol``), every group's AdamW moments
    within ``moment_tol`` of its largest, every rank logged rank 0's
    metrics and holds rank 0's parameters and moments.  Returns the worst moment
    difference."""
    worst = 0.0
    for c, case in enumerate(ranks[0]['cases']):
        for path, res in case.items():
            where = f'{what}: case {c}, {path}'
            for i, rec in enumerate(res['steps']):
                for k, w in rec['want'].items():
                    t = grad_norm_tol if k == 'grad_norm' else tol
                    g = rec['metrics'][k]
                    if not abs(g - w) <= t['atol'] + t['rtol'] * abs(w):
                        raise RuntimeError(f'{where}, step {i}: {k} {g} against the '
                                           f'one-process step\'s {w}')
                step_worst = max(rec['moments_worst'].values())
                if not step_worst <= moment_tol:
                    raise RuntimeError(f'{where}, step {i}: AdamW moments off the one-process '
                                       f'step\'s: {rec["moments_worst"]} of each group\'s '
                                       f'largest')
                worst = max(worst, step_worst)
                for r, other in enumerate(ranks):
                    if other['cases'][c][path]['steps'][i]['metrics'] != rec['metrics']:
                        raise RuntimeError(f'{where}, step {i}: rank {r} logged other metrics')
            for r, other in enumerate(ranks):
                if not other['cases'][c][path]['same_as_rank0']:
                    raise RuntimeError(f'{where}: rank {r}\'s parameters or moments differ '
                                       f'from rank 0\'s')
    return worst


def _replicated_equal(state, grid) -> bool:
    """Whether this rank's replicated parameters (every one but the
    decoder's shards) and their gradients are those of the first rank of
    its model group, bit for bit."""
    from superconductor_vae_tpu_torch.parallel.tensor import tp_sharded
    shards = {id(p) for n, p in state.decoder.named_parameters()
              if n in tp_sharded(state.decoder)}
    flat = torch.cat([t.detach().reshape(-1).float() for params, _ in state.groups()
                      for p in params if id(p) not in shards
                      for t in (p, p.grad if p.grad is not None else torch.zeros_like(p))])
    ref = flat.clone()
    broadcast_([ref], grid.model_group, src=grid.data_index * grid.n_model)
    return bool(torch.equal(ref, flat))


def _decode(rank, grid, job, device, luts) -> dict:
    """``job['decode']``: ``eval_batch`` of its batch through the
    tensor-parallel decoder of its case's state on every rank and, on rank
    0, through the whole decoder, in each of its compute ``dtypes``
    (float32 unless it says otherwise: the models rebuilt in that dtype
    from the same parameters); K1's launches counted over the first.
    Keys 'tp' and 'one', then 'tp bfloat16', 'one bfloat16', ..."""
    from superconductor_vae_tpu_torch.models import FormulaDecoder, MaterialsEncoder
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.parallel import shard_params_tp
    from superconductor_vae_tpu_torch.training import eval_batch
    spec = job['decode']
    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
    whole = torch.load(job['dir'] / f'state{spec["case"]}.pt', map_location=device,
                       weights_only=False)
    batch = {k: v.to(device) for k, v in spec['batch'].items()}
    masks = luts['type_masks'] if spec['type_masks'] else None
    keep = ('generated', 'margin', 'tf_pred')
    out = {}
    for dtype in spec.get('dtypes', (torch.float32,)):
        encoder, decoder = whole.encoder, whole.decoder
        if dtype != decoder.dtype:
            encoder = MaterialsEncoder(encoder.cfg, device=device, dtype=dtype)
            encoder.load_state_dict(whole.encoder.state_dict())
            decoder = FormulaDecoder(decoder.cfg, device=device, dtype=dtype)
            decoder.load_state_dict(whole.decoder.state_dict())
        encoder, decoder = encoder.eval(), decoder.eval()
        tp_decoder = shard_params_tp(decoder, grid).eval()
        suffix = '' if dtype == torch.float32 else ' ' + str(dtype).split('.')[1]
        with torch.no_grad():
            for name, dec in (('tp', tp_decoder), ('one', decoder)):
                if name == 'one' and rank != 0:
                    break
                sync()
                if name == 'tp':
                    dist.barrier(grid.model_group)
                decode_step_attention.launches = 0
                t0 = time.perf_counter()
                got = eval_batch(encoder, dec, batch, spec['gcfg'], type_masks=masks)
                sync()
                out[name + suffix] = {'seconds': time.perf_counter() - t0,
                                      'k1': decode_step_attention.launches,
                                      **{k: got[k].float().cpu() if got[k].is_floating_point()
                                         else got[k].cpu() for k in keep}}
    return out


def tp_steps(rank: int, world: int, job_dir: Path, device: torch.device) -> None:
    """One rank of ``run_tp``: on the job's (world / n_model x n_model)
    grid, for each case, this rank's ``shard_params_tp`` of the case's
    state, then the tensor-parallel step over each global batch in turn
    (this rank's data index's shard of it); after each, the whole state
    gathered (``gather_params_tp``), which on rank 0 is held against the
    one-process step from the state gathered before it.  K1's launches are
    counted over the TP step alone.  Then the job's decode.  Writes
    rank<r>.pt."""
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.parallel import (gather_params_tp, make_grid,
                                                       shard_params_tp)
    from superconductor_vae_tpu_torch.parallel.tensor import tp_sharded
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (build_luts, make_epoch_runner,
                                                       make_train_step)
    job = torch.load(job_dir / 'job.pt', weights_only=False)
    grid = make_grid(n_model=job['n_model'])
    cuda = device.type == 'cuda'
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    luts = build_luts(default_tokenizer(max_len=job['max_len']), device=device)
    batches = [{k: v.to(device) for k, v in b.items()} for b in job['batches']]
    seed, snapshots = job['seed'], job['snapshots']
    cases = []
    for c, case in enumerate(job['cases']):
        tcfg, dyn, rl = case['tcfg'], case['dyn'], case['rl']
        one_step = make_train_step(tcfg, luts, rl_enabled=rl)
        out = {}
        for path in case['paths']:
            whole = torch.load(job_dir / f'state{c}.pt', map_location=device,
                               weights_only=False)
            state = shard_params_tp(whole, grid)
            n_sharded = len(tp_sharded(state.decoder))
            if path == 'step':
                step = make_train_step(tcfg, luts, rl_enabled=rl, group=grid)
            else:
                runner = make_epoch_runner(tcfg, luts, rl_enabled=rl, group=grid)
                step = lambda s, b, k, d: runner(s, b, np.arange(len(b['tc']))[None],  # noqa: E731
                                                 k, d)
            steps = []
            for batch in batches[:case['steps']]:
                ref = whole if rank == 0 else None
                del whole
                shard = shard_batch(batch, grid.data_group)
                sync()
                dist.barrier()
                decode_step_attention.launches = 0
                t0 = time.perf_counter()
                state, metrics = step(state, shard if path == 'step' else batch, seed, dyn)
                sync()
                rec = {'seconds': time.perf_counter() - t0, 'k1': decode_step_attention.launches,
                       'rows': len(shard['tc']),
                       'metrics': {k: v.item() for k, v in metrics.items()},
                       'replicated_equal': _replicated_equal(state, grid)}
                whole = gather_params_tp(state, grid)
                if rank == 0:
                    t0 = time.perf_counter()
                    ref, want = one_step(ref, batch, seed, dyn)
                    sync()
                    rec.update(one_seconds=time.perf_counter() - t0,
                               want={k: v.item() for k, v in want.items()},
                               moments_worst=_moments_worst(whole, ref))
                    if snapshots:
                        rec['snapshot'], rec['one'] = snapshot(whole), snapshot(ref)
                    del ref
                steps.append(rec)
            out[path] = {'steps': steps, 'n_sharded': n_sharded,
                         'same_as_rank0': _same_as_rank0(whole, dist.group.WORLD)}
            del state, whole
        cases.append(out)
    decoded = _decode(rank, grid, dict(job, dir=job_dir), device, luts) \
        if job.get('decode') else None
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None
    torch.save({'cases': cases, 'decode': decoded, 'peak_gib': peak,
                'grid': (grid.data_index, grid.model_index)}, job_dir / f'rank{rank}.pt',
               pickle_protocol=pickle.HIGHEST_PROTOCOL)


def start_tp(job: dict, world: int, device: str = 'cpu', n_model: int = 2, backend=None,
             timeout: Optional[float] = None):
    """``tp_steps`` over ``job`` in ``world`` spawned ranks on a (world /
    ``n_model`` x ``n_model``) grid; returns at once a function that waits
    for them and returns their results.

    ``job`` as ``start_dp``'s, and optionally ``decode``: ``case`` (whose
    state decodes), ``batch`` (an eval batch of CPU tensors), ``gcfg`` (a
    ``GenerationConfig``), ``type_masks`` (whether the gates get the LUT's
    type masks) and optionally ``dtypes`` (the compute dtypes to decode
    in; float32 alone by default).  The results are each rank's: per case, per path,
    ``steps`` (as ``start_dp``'s, and ``replicated_equal``: the replicated
    parameters and their gradients equal to the first model rank's),
    ``n_sharded`` (the decoder's sharded parameters) and ``same_as_rank0``
    (the gathered parameters and moments after the last step); ``decode``
    ({'tp': ..., 'one': ... on rank 0, and 'tp bfloat16' ... for another
    dtype}: ``generated``, ``margin``, ``tf_pred``, ``seconds``, ``k1``);
    ``grid`` (data and model index);
    ``peak_gib``."""
    return start_dp(dict(job, n_model=n_model), world, device, backend, tp_steps, timeout)


def run_tp(job: dict, world: int, device: str = 'cpu', n_model: int = 2,
           backend=None, timeout: Optional[float] = None) -> List[dict]:
    """``start_tp``'s results, waited for."""
    return start_tp(job, world, device, n_model, backend, timeout)()


def check_tp(ranks: List[dict], tol: dict, grad_norm_tol: dict, moment_tol: float,
             what: str) -> float:
    """``check_dp``'s checks on a ``run_tp``'s results, and: the decoder
    has sharded parameters, every rank's replicated parameters and their
    gradients are its model group's first rank's after every step, every
    rank decoded the same streams, and the TP ``total`` is within JAX's
    dryrun tolerance (``TP_TOTAL_TOL``) of the one-process step's.  Returns
    the worst moment difference."""
    worst = check_dp(ranks, tol, grad_norm_tol, moment_tol, what)
    for c, case in enumerate(ranks[0]['cases']):
        for path, res in case.items():
            if res['n_sharded'] == 0:
                raise RuntimeError(f'{what}: case {c}, {path}: tensor parallelism degraded to '
                                   'replication: tp_param_specs shards no decoder parameter')
            for i, rec in enumerate(res['steps']):
                g, w = rec['metrics']['total'], rec['want']['total']
                if not abs(g - w) <= TP_TOTAL_TOL * (1 + abs(w)):
                    raise RuntimeError(f'{what}: case {c}, {path}, step {i}: total {g} '
                                       f'against {w}')
                for r, other in enumerate(ranks):
                    if not other['cases'][c][path]['steps'][i]['replicated_equal']:
                        raise RuntimeError(f'{what}: case {c}, {path}, step {i}: rank {r}\'s '
                                           'replicated parameters or gradients differ from '
                                           'its model group\'s')
    for key, res in (ranks[0]['decode'] or {}).items():
        if key.startswith('tp'):
            for r, other in enumerate(ranks):
                if not torch.equal(other['decode'][key]['generated'], res['generated']):
                    raise RuntimeError(f'{what}: rank {r} decoded other streams ({key})')
    return worst


def tiny_job(world: int) -> dict:
    """The CLI's job: ``tiny_test_config`` with a 512-wide latent at
    ``TrainConfig()``'s defaults, physics-Z on, dropout 0 everywhere, a
    synthetic global batch of 2 rows a rank, through the step and the
    epoch runner."""
    from superconductor_vae_tpu_torch.data import synthetic_dataset
    from superconductor_vae_tpu_torch.models import SetDecoderLayer, tiny_test_config
    from superconductor_vae_tpu_torch.models.physics_z import N_SUPERVISED
    from superconductor_vae_tpu_torch.training import (TrainConfig, create_train_state,
                                                       default_dyn)
    rows = 2 * world
    mcfg = dataclasses.replace(tiny_test_config(), latent_dim=N_SUPERVISED, dropout=0.0)
    tcfg = TrainConfig(batch_size=rows, max_formula_len=mcfg.max_len, use_physics_z=True)
    state = create_train_state(mcfg, tcfg, seed=0, device='cpu')
    for layer in state.set_decoder.children():
        if isinstance(layer, SetDecoderLayer):
            layer.dropout = 0.0
    ds = synthetic_dataset(n=rows, max_len=mcfg.max_len, magpie_dim=mcfg.magpie_dim)
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in ds.batch(np.arange(rows)).items()}
    batch = {k: v if v.is_floating_point() else v.long() for k, v in batch.items()}
    dyn = dict(default_dyn(tcfg), physz_w=1.0)
    return dict(cases=[dp_case(state, tcfg, dyn, paths=('step', 'runner'))], batches=[batch],
                max_len=mcfg.max_len, seed=0, snapshots=False)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('n', type=int, nargs='?', default=2, help='ranks')
    p.add_argument('--cuda', action='store_true',
                   help='NCCL, rank r on cuda:r % device_count (default: gloo on the CPU)')
    args = p.parse_args(argv)
    device = 'cuda' if args.cuda else 'cpu'
    job = tiny_job(args.n)
    ranks = run_dp(job, args.n, device)
    tol = dict(rtol=TOL, atol=1e-6)
    worst = check_dp(ranks, tol, tol, TOL, f'dryrun_multichip({args.n})')
    res = ranks[0]['cases'][0]
    n_model = 2 if args.n >= 4 and args.n % 2 == 0 else 1
    tp_note = f'TP arm skipped: n_model={n_model}'
    if n_model > 1:
        tp = run_tp(dict(job, cases=[dict(job['cases'][0], paths=('step',))]), args.n, device,
                    n_model)
        tp_worst = check_tp(tp, dict(rtol=1e-5, atol=1e-7), tol, TOL,
                            f'dryrun_multichip({args.n}) TP arm')
        rec = tp[0]['cases'][0]['step']
        dp_total = res['step']['steps'][0]['metrics']['total']
        if not abs(rec['steps'][0]['metrics']['total'] - dp_total) <= TP_TOTAL_TOL * (
                1 + abs(dp_total)):
            raise RuntimeError(f'dryrun_multichip({args.n}): the TP arm\'s total '
                               f'{rec["steps"][0]["metrics"]["total"]} against the DP '
                               f'arm\'s {dp_total}')
        tp_note = (f"TP arm on a {args.n // n_model} x {n_model} grid matches: loss="
                   f"{rec['steps'][0]['metrics']['total']:.4f} (moments {tp_worst:.1e}), "
                   f"{rec['n_sharded']} sharded decoder parameters")
    backend = 'nccl' if args.cuda else 'gloo'
    print(f'dryrun_multichip({args.n}, {backend}): OK — '
          f"DP loss={res['step']['steps'][0]['metrics']['total']:.4f}, "
          f"epoch_runner={res['runner']['steps'][0]['metrics']['total']:.4f}, each the "
          f"one-process step's within {TOL:g} (moments {worst:.1e}), parameters equal on "
          f'{args.n} ranks; {tp_note}', flush=True)


if __name__ == '__main__':
    main()
