"""``evaluate_autoregressive`` scores batch b on a worker thread while the
decode of batch b+1 runs (training/evaluate.py); here it is held to the
serial loop, written out below (eval_batch, the copies to the host and
``_score_batch`` one batch after another, then ``summarize_scores``):
every key of the result, row for row, bit for bit, with error records,
a padded last batch and ``max_batches``, while the interpreter switches
threads as often as it can."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from superconductor_vae_tpu_torch.data import synthetic_dataset
from superconductor_vae_tpu_torch.models import FormulaDecoder, MaterialsEncoder, init_params
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
from superconductor_vae_tpu_torch.training import build_luts, eval_train_config
from superconductor_vae_tpu_torch.training import evaluate as ev

import torch_port_threads  # noqa: F401  (one torch thread a process)

CFG = dataclasses.replace(tiny_test_config(), max_len=30)


def serial(encoder, decoder, ds, tcfg, luts, tokenizer, batch_size, max_batches=None):
    gcfg = ev.eval_generation_config(tcfg, CFG.max_len)
    rows = np.arange(len(ds))
    nb = -(-len(rows) // batch_size)
    if max_batches:
        nb = min(nb, max_batches)
    parts = []
    for b in range(nb):
        idx = rows[b * batch_size:(b + 1) * batch_size]
        full = np.concatenate([idx, np.zeros(batch_size - len(idx), np.int64)])
        out = ev.eval_batch(encoder, decoder, ev._to_device(ds.batch(full), 'cpu'), gcfg,
                            type_masks=luts['type_masks'])
        host = {k: (v.float() if v.is_floating_point() else v).cpu() for k, v in out.items()}
        parts.append(ev._score_batch(host, None, idx, ds, tokenizer))
    return ev.summarize_scores(parts, ds, rows)


@pytest.mark.parametrize('batch_size, max_batches', [(7, None), (8, 3)])
def test_overlapped_eval_equals_the_serial_loop(batch_size, max_batches):
    gen = torch.Generator().manual_seed(0)
    encoder = init_params(MaterialsEncoder(CFG, device='cpu'), gen).eval()
    decoder = init_params(FormulaDecoder(CFG, device='cpu'), gen).eval()
    with torch.no_grad():                      # rollouts that run, not stop at once
        decoder.stop_d2.weight.zero_()
        decoder.stop_d2.bias.fill_(-4.0)
    ds = synthetic_dataset(n=40, max_len=CFG.max_len, magpie_dim=CFG.magpie_dim, seed=1)
    tok = default_tokenizer(max_len=CFG.max_len)
    tcfg = eval_train_config(CFG.max_len)
    luts = build_luts(tok, device='cpu')
    want = serial(encoder, decoder, ds, tcfg, luts, tok, batch_size, max_batches)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = ev.evaluate_autoregressive(encoder, decoder, ds, tcfg, luts, tokenizer=tok,
                                         batch_size=batch_size, max_batches=max_batches,
                                         collect_errors=True)
    finally:
        sys.setswitchinterval(interval)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
        else:
            assert got[k] == v, k
    assert got['n_evaluated'] == (24 if max_batches else 40)
    assert 0 < len(got['error_records']) and np.isfinite(got['per_sample_margin']).any()
