"""The ``train()`` ranks of tests/test_torch_port_distributed.py, started
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
