"""The ``train()`` ranks of tests/test_torch_port_distributed.py and the
shard/gather ranks of tests/test_torch_port_tensor_parallel.py, started
by ``scripts/dryrun_multichip.py`` ``spawn`` (gloo on the CPU, one torch
thread each, a fresh interpreter that imports torch and the port, and no
JAX).

The parent writes the job's inputs with ``torch.save`` into the job's
directory; every rank writes its results beside them as ``rank<r>.pt``.
"""

import signal

import torch

from superconductor_vae_tpu_torch.scripts.dryrun_multichip import snapshot


def dp_train(rank, world, job_dir, device):
    """``train()`` for the job's first epochs, then again resuming from
    its checkpoint; then a run that a SIGINT on the last rank cuts."""
    import superconductor_vae_tpu_torch.training.train_loop as loop_mod
    from superconductor_vae_tpu_torch.training import train
    job = torch.load(job_dir / 'inputs.pt', weights_only=False)
    quiet = lambda *a, **k: None  # noqa: E731
    kw = dict(model_config=job['mcfg'], dataset=job['dataset'], log_fn=quiet, device=device,
              output_dir=job_dir / 'run')
    first = train(train_config=job['tc_first'], **kw)
    rest = train(train_config=job['tc_rest'], **kw)
    # a SIGINT on the last rank during its first epoch stops every rank
    # after that epoch, with one 'interrupt' checkpoint
    real_lr = loop_mod.cosine_lr

    def lr_then_signal(epoch, tcfg):
        if epoch == 0 and rank == world - 1:
            signal.raise_signal(signal.SIGINT)
        return real_lr(epoch, tcfg)
    loop_mod.cosine_lr = lr_then_signal
    cut = train(train_config=job['tc_rest'], **dict(kw, output_dir=job_dir / 'cut'))
    torch.save({'first': first['history'], 'cut': cut['history'],
                'rest': (rest['history'], snapshot(rest['state'])),
                'rest_params': {name: {k: v.numpy().copy() for k, v in m.state_dict().items()}
                                for name, m in (('enc_params', rest['encoder']),
                                                ('dec_params', rest['decoder']))}},
               job_dir / f'rank{rank}.pt')


def _state_tensors(state):
    """Every tensor of a train state's modules and optimizers, by name."""
    out = {}
    for name in ('encoder', 'decoder', 'pz_proj', 'set_decoder'):
        module = getattr(state, name)
        if module is not None:
            out.update({f'{name}.{k}': v for k, v in module.state_dict().items()})
    for name in ('enc_opt', 'dec_opt', 'pz_opt', 'set_opt'):
        opt = getattr(state, name)
        if opt is None:
            continue
        sd = opt.state_dict()
        inner = sd.get('inner', sd)
        for i, st in inner['state'].items():
            out.update({f'{name}.{i}.{k}': v for k, v in st.items()})
        for i, a in enumerate(sd.get('acc_grads', ())):
            out[f'{name}.acc.{i}'] = a
    return out


def tp_round_trip(rank, world, job_dir, device):
    """On a 1 x world grid: ``shard_params_tp`` then ``gather_params_tp`` of
    the job's train states (a port checkpoint's, read back as ``train()``
    resumes, and one under gradient accumulation after a mini-step) and
    of a decoder converted by checkpoint/from_jax.py, each against its
    source; the gathered checkpoint state saved again; and
    ``check_equal_across`` on tensors equal and unequal across the ranks."""
    from superconductor_vae_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from superconductor_vae_tpu_torch.parallel import (gather_params_tp, make_grid,
                                                       shard_params_tp)
    from superconductor_vae_tpu_torch.parallel.tensor import check_equal_across, tp_sharded
    from superconductor_vae_tpu_torch.training import create_train_state
    job = torch.load(job_dir / 'inputs.pt', weights_only=False)
    grid = make_grid(n_model=world)
    restored, meta = load_checkpoint(job_dir / 'ckpt')
    state = create_train_state(job['mcfg'], job['tcfg'], seed=5, device=device)
    for name, key in (('encoder', 'enc_params'), ('decoder', 'dec_params'),
                      ('pz_proj', 'pz_params'), ('set_decoder', 'set_params'),
                      ('enc_opt', 'enc_opt'), ('dec_opt', 'dec_opt'), ('pz_opt', 'pz_opt'),
                      ('set_opt', 'set_opt')):
        getattr(state, name).load_state_dict(restored[key])
    state.step = restored['step']
    result = {}
    for what, src in (('checkpoint', state), ('accumulation', job['accum_state'])):
        shards = shard_params_tp(src, grid)
        back = gather_params_tp(shards, grid)
        want, got = _state_tensors(src), _state_tensors(back)
        result[what] = (got.keys() == want.keys()
                        and all(torch.equal(got[k], want[k]) for k in want)
                        and back.step == src.step)
        result[f'{what} sharded'] = len(tp_sharded(shards.decoder))
        result[f'{what} smaller'] = (sum(p.numel() for p in shards.decoder.parameters())
                                     < sum(p.numel() for p in src.decoder.parameters()))
        if what == 'checkpoint' and rank == 0:
            save_checkpoint(job_dir, back, job['mcfg'], job['tcfg'], epoch=0, tag='again')
    converted = job['converted']
    back = gather_params_tp(shard_params_tp(converted, grid), grid)
    result['from_jax'] = all(torch.equal(back.state_dict()[k], v)
                             for k, v in converted.state_dict().items())
    same = torch.arange(6)
    check_equal_across(same, grid, 'equal tokens')
    try:
        check_equal_across(same + (rank == world - 1), grid, 'unequal tokens')
        result['raised'] = ''
    except RuntimeError as e:
        result['raised'] = str(e)
    torch.save(result, job_dir / f'rank{rank}.pt')
