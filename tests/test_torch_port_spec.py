"""The decoding variants of the port against the JAX package: the n-gram
draft tables (models/draft.py), the decoder's chunk forwards
(``decode_chunk``, ``decode_chunk_perrow``), speculative decoding
(generation/speculative.py), the speculative eval and the eval CLI's
``--speculative`` (the bench's ``--spec`` is in test_torch_port_bench.py).

Tiny widths, the same numpy weights on both sides (``param_trees``).  The
draft tables are bit-equal; speculative tokens, masks, acceptance rates
and iteration counts equal; the eval's exact match equal row by row; the
chunk forwards' heads and caches within 1e-5 relative (float32, other
summation orders), with an absolute floor of 1e-5 of the tensor's
largest magnitude for the elements near zero.
"""

import dataclasses
import gzip
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superconductor_vae_tpu.training.evaluate as jax_evaluate_mod
from superconductor_vae_tpu.data import pipeline as jax_pipeline
from superconductor_vae_tpu.generation.speculative import (
    speculative_generate as jax_speculative)
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.models import draft as jax_draft
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu.training import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu.training.train_step import build_luts as jax_luts
from superconductor_vae_tpu_torch.data import load_dataset, read_csv_rows
from superconductor_vae_tpu_torch.generation import GenerationConfig, generate_with_kv_cache
from superconductor_vae_tpu_torch.generation.speculative import speculative_generate
from superconductor_vae_tpu_torch.models import FormulaDecoder, tiny_test_config
from superconductor_vae_tpu_torch.models import draft
from superconductor_vae_tpu_torch.models.decoder import plain_layout
from superconductor_vae_tpu_torch.scripts import evaluate as cli
from superconductor_vae_tpu_torch.tokenizer import BOS_ID, EOS_ID, default_tokenizer
from superconductor_vae_tpu_torch.training import (
    build_luts, eval_train_config, evaluate_autoregressive)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import export_params_npz, jax_config, param_trees, port_models

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
META = json.loads((ROOT / 'results/run4/ckpt_snapshot/meta.json').read_text())
CFG = tiny_test_config()
RTOL = 1e-5
HEADS = ('logits', 'stop_logits', 'type_logits', 'site_dup_logits')
B, K = 6, 4


# -- the draft tables ---------------------------------------------------------

def _synthetic_tokens():
    """Token rows over a small alphabet (so that contexts repeat and
    successor counts tie) with PAD tails of varied length."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 60, (400, 14))
    lengths = rng.integers(3, 15, 400)
    return np.where(np.arange(14)[None, :] < lengths[:, None], tokens, 0).astype(np.int64)


def _corpus_stream(n=2000):
    """The first ``n`` corpus rows as the eval CLI builds its draft stream:
    BOS in column 0, then each formula's tokens."""
    tokens = default_tokenizer(max_len=30).encode_batch(read_csv_rows(CSV, n)['formula'])
    return np.concatenate([np.full((n, 1), BOS_ID, np.int64),
                           tokens.astype(np.int64)[:, 1:]], axis=1)


@pytest.mark.parametrize('grammar', [True, False], ids=['grammar', 'free'])
@pytest.mark.parametrize('source', ['synthetic', 'corpus'])
def test_draft_tables_bit_equal(source, grammar):
    tokens = _synthetic_tokens() if source == 'synthetic' else _corpus_stream()
    got = draft.build_ngram_draft(tokens, default_tokenizer(max_len=30),
                                  grammar_constrained=grammar)
    want = jax_draft.build_ngram_draft(tokens, jax_tokenizer(max_len=30),
                                       grammar_constrained=grammar)
    for name in ('bigram', 'trigram'):
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (got['trigram'] >= 0).sum() > 100 and (got['bigram'] != EOS_ID).sum() > 20
    bigram = draft.build_bigram_draft(tokens, default_tokenizer(max_len=30),
                                      grammar_constrained=grammar)
    np.testing.assert_array_equal(bigram, want['bigram'])


def test_draft_save_and_load_across_packages(tmp_path):
    tokens = _synthetic_tokens()
    d = draft.build_ngram_draft(tokens, default_tokenizer(max_len=30))
    draft.save_draft(tmp_path / 'ngram.npz', d)
    draft.save_draft(tmp_path / 'bigram.npz', d['bigram'])
    for load in (draft.load_draft, jax_draft.load_draft):
        got = load(tmp_path / 'ngram.npz')
        assert set(got) == {'bigram', 'trigram'}
        for name in got:
            assert got[name].dtype == d[name].dtype
            np.testing.assert_array_equal(got[name], d[name])
        np.testing.assert_array_equal(load(tmp_path / 'bigram.npz'), d['bigram'])
        assert load(tmp_path / 'missing.npz') is None
    jax_draft.save_draft(tmp_path / 'jax.npz', d)
    np.testing.assert_array_equal(draft.load_draft(tmp_path / 'jax.npz')['trigram'],
                                  d['trigram'])


# -- the chunk forwards -------------------------------------------------------

@pytest.fixture(scope='module')
def models():
    """Tiny weights and inputs, the JAX decoder and the port's (eval mode).
    The EOS logit's bias is raised by 2, so that the greedy streams end at
    varied steps (10 to 15 of 15; the top-two gaps stay above 2.5e-4)."""
    trees = param_trees(CFG, seed=5)
    trees[1]['params']['out_d2']['bias'][EOS_ID] += 2.0
    rng = np.random.default_rng(6)
    inputs = (rng.standard_normal((B, CFG.latent_dim)).astype(np.float32),
              rng.standard_normal((B, CFG.stoich_input_dim)).astype(np.float32),
              rng.standard_normal((B, CFG.heads_input_dim)).astype(np.float32))
    _, dec = port_models(CFG, trees)
    return trees, inputs, JaxDecoder(jax_config(CFG)), dec.eval()


def _jax_memory(jdec, params, inputs):
    memory = jdec.apply(params, *inputs, method=JaxDecoder.build_memory)
    return jdec.apply(params, memory, method=JaxDecoder.memory_kv)


def _port_memory(dec, inputs):
    with torch.no_grad():
        return dec.memory_kv(dec.build_memory(*(torch.tensor(x) for x in inputs)))


def assert_close(got, want, what=''):
    """1e-5 relative, with a floor of 1e-5 of the largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=what)


def _assert_chunk_close(heads, caches, jheads, jcaches):
    for key in HEADS:
        assert_close(heads[key].numpy(), jheads[key], key)
    for got, want in zip(caches, jcaches):
        assert_close(got.numpy(), want, 'cache')


@pytest.mark.parametrize('perrow', [False, True], ids=['chunk', 'perrow'])
def test_chunk_forwards_match_jax(models, perrow):
    """Three chunk calls of K + 1 tokens into caches with K + 1 slack rows
    (as speculative decoding allocates them): the last call of
    ``decode_chunk`` starts past the cache's end (its write clamps, as
    XLA's), and in ``decode_chunk_perrow`` rows start at different
    positions, one of them past the positional table's end, where the
    positions clip."""
    trees, inputs, jdec, dec = models
    c = K + 1
    rows = CFG.max_len + 8
    if perrow:
        starts = [np.array([0, 3, 7, 11, 2, rows - 2]), np.array([4, 5, 12, 16, 2, rows - 1]),
                  np.array([9, 10, 15, 18, 3, rows + 1])]
        method, port_fn = JaxDecoder.decode_chunk_perrow, dec.decode_chunk_perrow
    else:
        starts = [0, 7, CFG.max_len + 2]
        method, port_fn = JaxDecoder.decode_chunk, dec.decode_chunk
    jmem = _jax_memory(jdec, trees[1], inputs)
    kc_j, vc_j = jdec.apply(trees[1], B, c, method=JaxDecoder.init_cache)
    mem = _port_memory(dec, inputs)
    kc, vc = dec.init_cache(B, c)
    assert kc.shape == (CFG.num_layers, B, CFG.max_len + c, CFG.nhead, CFG.head_dim)
    rng = np.random.default_rng(7)
    call = jax.jit(lambda p, t, s, kc, vc, m: jdec.apply(p, t, s, kc, vc, m, method=method))
    for start in starts:
        tokens = rng.integers(3, CFG.vocab_size, (B, c)).astype(np.int32)
        jheads, kc_j, vc_j = call(trees[1], tokens,
                                  jnp.asarray(start, jnp.int32), kc_j, vc_j, jmem)
        pos = torch.as_tensor(start) if perrow else start
        with torch.no_grad():
            heads, kc, vc = port_fn(torch.as_tensor(tokens).long(), pos, kc, vc, mem)
        _assert_chunk_close(heads, (kc, vc), jheads, (kc_j, vc_j))
    assert float(kc[:, :, -1].abs().max()) > 0          # the tail slots were written


def test_chunk_forward_refuses_the_kernel_layout(models):
    dec = FormulaDecoder(dataclasses.replace(CFG, pallas_decode=True), device='cpu')
    with pytest.raises(ValueError, match='layout'):
        dec.init_cache(2, 5)
    kc, vc = dec.init_cache(2)
    with pytest.raises(ValueError, match='layout'):
        dec.decode_chunk(torch.zeros(2, 5, dtype=torch.long), 0, kc, vc, None)
    twin = plain_layout(dec)
    assert not twin.cfg.pallas_decode and twin.init_cache(2, 5)[0].shape[2] == CFG.max_len + 5
    assert all(a is b for a, b in zip(dec.parameters(), twin.parameters()))


# -- speculative decoding -----------------------------------------------------

@pytest.fixture(scope='module')
def greedy(models):
    """The port's plain greedy scan (no gates, every step) and the drafts
    built from its stream, as bench.py builds them."""
    trees, inputs, jdec, dec = models
    out = generate_with_kv_cache(dec, *(torch.tensor(x) for x in inputs), None,
                                 GenerationConfig(max_len=CFG.max_len, temperature=0.0))
    stream = np.concatenate([np.full((B, 1), BOS_ID, np.int64), out['tokens'].numpy()], 1)
    d = draft.build_ngram_draft(stream, default_tokenizer(max_len=CFG.max_len),
                                grammar_constrained=False)
    drafts = {'garbage': np.full(CFG.vocab_size, 7, np.int32), 'bigram': d['bigram'],
              'trigram': d}
    return out, drafts


@pytest.mark.parametrize('kind', ['garbage', 'bigram', 'trigram'])
def test_speculative_generate_matches_jax(models, greedy, kind):
    trees, inputs, jdec, dec = models
    ref, drafts = greedy
    table = drafts[kind]
    jtable = ({k: jnp.asarray(v) for k, v in table.items()} if isinstance(table, dict)
              else jnp.asarray(table))
    want = jax.jit(lambda p, t: jax_speculative(jdec, p, *inputs, t, k=K))(trees[1], jtable)
    got = speculative_generate(dec, *(torch.tensor(x) for x in inputs), table, k=K)
    np.testing.assert_array_equal(got['tokens'].numpy(), np.asarray(want['tokens']))
    np.testing.assert_array_equal(got['mask'].numpy(), np.asarray(want['mask']))
    assert got['acceptance_rate'].dtype == torch.float32
    assert got['acceptance_rate'].item() == float(want['acceptance_rate'])
    assert got['n_iterations'] == int(want['n_iterations'])
    # the defining property: the plain greedy stream up to each row's EOS
    mask = ref['mask'].bool()
    assert torch.equal(torch.where(mask, got['tokens'], 0), torch.where(mask, ref['tokens'], 0))
    assert torch.equal(got['mask'], ref['mask'])
    steps = CFG.max_len - 1
    ends = ref['mask'].sum(dim=1).tolist()
    assert len(set(ends)) > 1 and max(ends) > 4, ends       # rows of varied lengths
    if kind == 'garbage':
        assert got['acceptance_rate'].item() < 0.1 and got['n_iterations'] >= max(ends) - 1
    else:
        assert got['acceptance_rate'].item() > 0.3 and got['n_iterations'] < steps
    # the margin: the top-two gap of the step that emitted each token
    assert bool((got['margin'][mask] > 0).all())


# -- the speculative eval and the CLI ------------------------------------------

def _eval_trees(cfg):
    return param_trees(cfg, seed=2)


@pytest.fixture(scope='module')
def spec_eval(tmp_path_factory):
    """The corpus's first 48 rows (a CSV of its head, so that the loads are
    quick) at tiny width (magpie_dim 78, max_len 30) with the draft of
    their own token stream (BOS first, as the eval CLI builds it): the JAX
    eval with speculative tables against the port's."""
    tmp = tmp_path_factory.mktemp('spec_cli')
    with gzip.open(CSV, 'rt') as f:
        (tmp / 'head.csv').write_text(''.join(next(f) for _ in range(49)))
    cfg = dataclasses.replace(CFG, magpie_dim=78, max_len=30)
    trees = _eval_trees(cfg)
    ds = load_dataset(tmp / 'head.csv', max_len=30, skew_transform='rank_gauss')
    jds = jax_pipeline.load_dataset(tmp / 'head.csv', max_len=30, skew_transform='rank_gauss',
                                    cache_dir=None)
    np.testing.assert_array_equal(ds.tokens, jds.tokens)
    stream = np.concatenate([np.full((len(ds), 1), BOS_ID, np.int64),
                             ds.tokens.astype(np.int64)[:, 1:]], axis=1)
    tables = draft.build_ngram_draft(stream, default_tokenizer(max_len=30))
    jcfg = jax_config(cfg)
    tcfg = JaxTrainConfig(max_formula_len=30)
    for k, v in META['eval_gating'].items():
        setattr(tcfg, k, v)
    want = jax_evaluate_mod.evaluate_autoregressive(
        JaxEncoder(jcfg), JaxDecoder(jcfg), trees[0], trees[1], jds, tcfg,
        jax_luts(jax_tokenizer(max_len=30)), batch_size=16, collect_errors=True,
        tokenizer=jax_tokenizer(max_len=30), speculative_tables={k: jnp.asarray(v) for k, v in tables.items()})
    enc, dec = port_models(cfg, trees)
    got = evaluate_autoregressive(enc, dec, ds, eval_train_config(30, META['eval_gating']),
                                  build_luts(default_tokenizer(max_len=30), device='cpu'),
                                  batch_size=16, collect_errors=True,
                                  tokenizer=default_tokenizer(max_len=30),
                                  speculative_tables=tables)
    return cfg, trees, got, want, tmp


def test_evaluate_autoregressive_speculative_matches_jax(spec_eval):
    _, _, got, want, _ = spec_eval
    np.testing.assert_array_equal(got['per_sample_ar_exact'], want['per_sample_ar_exact'])
    np.testing.assert_array_equal(got['position_errors'], want['position_errors'])
    assert (got['ar_exact'], got['tf_exact'], got['n_evaluated']) == (
        want['ar_exact'], want['tf_exact'], want['n_evaluated'])
    assert got['n_evaluated'] == 46                 # 48 rows, 2 dropped by the filters
    assert np.isfinite(got['per_sample_margin']).all()
    # each inexact row's decoded stream: the speculative tokens themselves
    assert [(e['index'], e['generated']) for e in got['error_records']] == [
        (e['index'], e['generated']) for e in want['error_records']]
    assert len(got['error_records']) > 40


def test_eval_cli_speculative_on_a_tiny_npz(spec_eval):
    cfg, trees, _, want, tmp = spec_eval
    npz = tmp / 'tiny.npz'
    export_params_npz({'enc_params': trees[0], 'dec_params': trees[1]}, npz)
    meta = dict(META, model_config=json.loads(json.dumps(dataclasses.asdict(cfg))))
    meta.pop('manifest', None)
    (tmp / 'meta.json').write_text(json.dumps(meta))
    args = ['--params', str(npz), '--meta', str(tmp / 'meta.json'), '--csv',
            str(tmp / 'head.csv'), '--batch-size', '16', '--cpu']
    cli.main(args + ['--speculative', '--out', str(tmp / 'summary.json'),
                     '--errors-out', str(tmp / 'errors.jsonl')])
    got = json.loads((tmp / 'summary.json').read_text())
    errors = [json.loads(x) for x in (tmp / 'errors.jsonl').read_text().splitlines()]
    assert got['decode_path'] == 'speculative' and got['n_evaluated'] == 46
    assert (got['true_ar_exact'], got['tf_exact']) == (want['ar_exact'], want['tf_exact'])
    assert [(e['index'], e['generated']) for e in errors] == [
        (e['index'], e['generated']) for e in want['error_records']]
    with pytest.raises(SystemExit):
        cli.main(args + ['--speculative', '--pallas-decode'])

