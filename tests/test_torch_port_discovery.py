"""The port's discovery slice against the JAX package: chem/featurize.py,
``predict_tc_mc``, ``CandidateGenerator`` and
``SuperconductorDiscoveryPipeline`` (generation/discovery.py), at tiny
widths on the same numpy parameters (``params_from_jax``).

Random draws cannot match across frameworks (torch generators against JAX
keys), so the tests record the port's draws and feed them to JAX
(``FedDraws``: JAX's ``jax.random`` in the modules that draw is replaced in
the test; no JAX file changes), and feed JAX the port's MC-dropout Tc.

Tolerance: featurize, token streams and formulas are equal; gradients with
respect to z within 1e-5 of their largest component; latents within 1e-4 (float32 on both
sides, other summation orders, through up to 20 normalised ascent steps);
scores within 1e-5 relative.
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superconductor_vae_tpu.generation.candidate_generator as jcg_mod
import superconductor_vae_tpu.generation.latent as jlatent
import superconductor_vae_tpu.models.encoder as jenc_mod
from superconductor_vae_tpu.chem import featurize as jfeat
from superconductor_vae_tpu.data import synthetic_dataset as jax_synthetic
from superconductor_vae_tpu.generation import SuperconductorDiscoveryPipeline as JaxPipeline
from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu_torch.chem import featurize as pfeat
from superconductor_vae_tpu_torch.data import read_csv_rows, synthetic_dataset
from superconductor_vae_tpu_torch.generation import (
    Candidate, CandidateGenerator, LatentCache, LatentSpaceAnalyzer,
    SuperconductorDiscoveryPipeline)
from superconductor_vae_tpu_torch.generation import discovery as pdisc
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.models.encoder import predict_tc_mc
from superconductor_vae_tpu_torch.tokenizer import (
    BOS_ID, ELEMENT_TOKEN_START, EOS_ID, TOKEN_TYPE_ELEMENT, default_tokenizer)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import (
    FedDraws, fix_rollout_heads, jax_config, param_trees, port_models)

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
CFG = tiny_test_config()
N_ROWS = 48
Z_TOL = dict(rtol=1e-4, atol=1e-4)
EDGE_FORMULAS = ['', 'Xx2', 'H', 'C60', 'YBa2Cu3O7', 'Fe(1/2)Se(1/2)', 'Og3Ts',
                 'La(1//2)CuO4', 'NaCl)', '(3/4)', 'B2Mg', 'Mg(97/100)Na(3/100)B2',
                 'Hg(33/50)Pb(17/50)Ba2Ca(99/50)Cu(29/10)O(42/5)']


# -- featurize ----------------------------------------------------------------------

def test_featurize_equals_jax():
    formulas = read_csv_rows(CSV, n_rows=2000)['formula'] + EDGE_FORMULAS
    assert pfeat.FEATURE_NAMES == jfeat.FEATURE_NAMES and pfeat.N_FEATURES == 78
    got, want = pfeat.featurize_formulas(formulas), jfeat.featurize_formulas(formulas)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for comp in ({}, {'Xx': 1.0}, {'Cu': 0.0}, {'Y': 1, 'Ba': 2, 'Cu': 3, 'O': 6.5}):
        np.testing.assert_array_equal(pfeat.composition_features(comp),
                                      jfeat.composition_features(comp))


def test_magpie_bridge_equals_jax(tmp_path):
    """The bridge fit on a CSV of the corpus's first 300 rows (the port
    reads it with the standard library, JAX with pandas), its save, load
    and application."""
    import gzip
    with gzip.open(CSV, 'rt') as fh:
        lines = [next(fh) for _ in range(301)]
    csv = tmp_path / 'head.csv'
    csv.write_text(''.join(lines))
    got = pfeat.fit_magpie_bridge(csv, tmp_path / 'port.npz', limit=250)
    want = jfeat.fit_magpie_bridge(csv, tmp_path / 'jax.npz', limit=250)
    assert list(got['columns']) == list(want['columns']) and len(got['columns']) == 78
    np.testing.assert_allclose(got['w'], want['w'], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got['r2'], want['r2'], rtol=1e-5, atol=1e-5)
    loaded = pfeat.load_magpie_bridge(tmp_path / 'port.npz')
    feats = pfeat.featurize_formulas(['YBa2Cu3O7', 'MgB2'])
    np.testing.assert_array_equal(pfeat.apply_magpie_bridge(feats, loaded),
                                  jfeat.apply_magpie_bridge(feats, loaded))
    with pytest.raises(ValueError):
        pfeat.apply_magpie_bridge(feats[:, :10], loaded)


# -- shared set-up ------------------------------------------------------------------

@pytest.fixture(scope='module')
def sides():
    """The port's and JAX's pipelines on the same weights and rows."""
    trees = fix_rollout_heads(param_trees(CFG, seed=3))
    enc, dec = port_models(CFG, trees)
    tok = default_tokenizer(max_len=CFG.max_len)
    ds = synthetic_dataset(n=N_ROWS, max_len=CFG.max_len, magpie_dim=CFG.magpie_dim)
    jtok = jax_tokenizer(max_len=CFG.max_len)
    jds = jax_synthetic(n=N_ROWS, max_len=CFG.max_len, magpie_dim=CFG.magpie_dim)
    assert ds.formulas == jds.formulas
    np.testing.assert_array_equal(ds.magpie, jds.magpie)
    jcfg = jax_config(CFG)
    jpipe = JaxPipeline(JaxEncoder(jcfg), JaxDecoder(jcfg), trees[0], trees[1], jtok, jds,
                        type_masks=jnp.asarray(jtok.type_masks))
    pipe = SuperconductorDiscoveryPipeline(enc, dec, tok, ds, type_masks=tok.type_masks)
    return pipe, jpipe


def _latents(n, seed=7, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, CFG.latent_dim))
            ).astype(np.float32)


# -- predict_tc_mc ------------------------------------------------------------------

def test_predict_tc_mc_no_dropout_is_tc_pred(sides):
    trees = param_trees(CFG, seed=3)
    enc, _ = port_models(dataclasses.replace(CFG, dropout=0.0), trees)
    z = torch.as_tensor(_latents(6))
    enc.train()
    mean, std = predict_tc_mc(enc, z, seed=5)
    assert enc.training
    enc.eval()
    with torch.no_grad():
        tc = enc.decode(z)['tc_pred']
    torch.testing.assert_close(mean, tc, rtol=1e-6, atol=1e-6)
    assert torch.equal(std, torch.zeros(6))


def test_predict_tc_mc_dropout(sides):
    """Dropout on in ``decode`` alone: N passes of the seeded stream, their
    mean and unbiased std; the caller's global stream, the encoder's mode,
    its parameters and their ``.grad`` are left as they were."""
    enc = sides[0].encoder
    z = torch.as_tensor(_latents(6))
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    torch.manual_seed(123)
    state = torch.get_rng_state()
    mean, std = predict_tc_mc(enc, z, seed=5, n_samples=10)
    assert torch.equal(torch.get_rng_state(), state)
    assert not enc.training
    assert all(torch.equal(before[k], v) for k, v in enc.state_dict().items())
    assert all(p.grad is None for p in enc.parameters())
    again = predict_tc_mc(enc, z, seed=5, n_samples=10)
    assert torch.equal(mean, again[0]) and torch.equal(std, again[1])
    assert not torch.equal(mean, predict_tc_mc(enc, z, seed=6, n_samples=10)[0])
    # the same N passes by hand: z stacked N times, one stream
    with torch.random.fork_rng():
        torch.manual_seed(5)
        enc.train()
        with torch.no_grad():
            preds = enc.decode(z.repeat(10, 1))['tc_pred'].reshape(10, 6)
        enc.eval()
    torch.testing.assert_close(mean, preds.mean(0))
    torch.testing.assert_close(std, torch.as_tensor(np.std(preds.numpy(), axis=0, ddof=1)))
    assert (std > 0).all()


# -- CandidateGenerator -------------------------------------------------------------

def test_gradient_ascent_equals_jax(sides):
    pipe, jpipe = sides
    z = _latents(12)
    g = pipe.generator.tc_grad(torch.as_tensor(z))
    jg = jpipe.generator._tc_grad(jnp.asarray(z))
    err = np.abs(g.numpy() - np.asarray(jg)).max()
    assert err <= 1e-5 * np.abs(np.asarray(jg)).max()
    got = pipe.generator.gradient_ascent_tc(z)
    want = np.asarray(jpipe.generator.gradient_ascent_tc(jnp.asarray(z)))
    np.testing.assert_allclose(got.numpy(), want, **Z_TOL)
    assert np.linalg.norm(got.numpy() - z) > 1.0            # the ascent moved
    assert all(p.grad is None for p in pipe.encoder.parameters())
    np.testing.assert_allclose(pipe.generator.predicted_tc(z),
                               jpipe.generator.predicted_tc(jnp.asarray(z)), rtol=1e-5,
                               atol=1e-6)


def test_sample_interpolate_evolve_with_fed_draws(sides, monkeypatch):
    pipe, jpipe = sides
    z = _latents(16)
    fed = FedDraws()
    with fed.recording():
        clusters = pipe.generator.sample_clusters(z[:3], 5, 0.5, torch.Generator().manual_seed(0))
        evolved = pipe.generator.evolutionary(z, torch.Generator().manual_seed(1))
    fed.feeding(monkeypatch, jlatent, jcg_mod)
    np.testing.assert_allclose(
        clusters.numpy(), np.asarray(jpipe.generator.sample_clusters(
            z[:3], 5, 0.5, jax.random.PRNGKey(0))), rtol=1e-6, atol=1e-6)
    with jax.disable_jit():                   # a jitted generation draws at tracing only
        jevolved = jpipe.generator.evolutionary(jnp.asarray(z), jax.random.PRNGKey(1))
    assert fed.exhausted()
    assert evolved.shape == (16, CFG.latent_dim)
    np.testing.assert_allclose(evolved.numpy(), np.asarray(jevolved), **Z_TOL)
    for spherical in (True, False):
        np.testing.assert_allclose(
            pipe.generator.interpolate_pairs(z[:3], z[3:6], n=8, spherical=spherical).numpy(),
            np.asarray(jpipe.generator.interpolate_pairs(
                jnp.asarray(z[:3]), jnp.asarray(z[3:6]), n=8, spherical=spherical)),
            rtol=1e-5, atol=1e-5)


# -- decode_latents / decode_conditioned --------------------------------------------

@pytest.mark.parametrize('mode', [
    dict(snap_stoich=True, chunk=16),              # 40 rows: two chunks and a padded third
    dict(pure_greedy=True, chunk=16),
    dict(),                                        # one batch, gated, no snap
])
def test_decode_latents_equals_jax(sides, mode):
    pipe, jpipe = sides
    z = _latents(40 if 'chunk' in mode else 16, seed=11, scale=2.0)
    got = pipe.decode_latents(z, **mode)
    want = jpipe.decode_latents(jnp.asarray(z), **mode)
    assert got == want
    assert len(set(got)) > 4                       # the rows decode differently


def test_decode_latents_type_masks_and_sampling(sides):
    """Explicit type masks take the pipeline's place; a sampled decode draws
    from its generator (the same stream gives the same formulas, the
    padded rows included in the chunks but not in the output)."""
    pipe, jpipe = sides
    z = _latents(20, seed=12, scale=2.0)
    masks = np.array(pipe.tokenizer.type_masks)
    masks[TOKEN_TYPE_ELEMENT] = False
    for z_el in (26, 7):                           # the elements Fe and N only
        masks[TOKEN_TYPE_ELEMENT, ELEMENT_TOKEN_START + z_el - 1] = True
    got = pipe.decode_latents(z, type_masks=masks, chunk=16)
    assert got == jpipe.decode_latents(jnp.asarray(z), type_masks=jnp.asarray(masks), chunk=16)
    a = pipe.decode_latents(z, temperature=0.7, generator=torch.Generator().manual_seed(3),
                            chunk=16)
    b = pipe.decode_latents(z, temperature=0.7, generator=torch.Generator().manual_seed(3),
                            chunk=16)
    assert a == b and len(a) == 20 and a != pipe.decode_latents(z, chunk=16)


def test_pure_greedy_decode_is_tf_argmax_fixed_point(sides):
    """JAX's property, on the port: re-feeding the ungated argmax rollout
    through the teacher-forced forward reproduces it at every position up
    to EOS."""
    from superconductor_vae_tpu_torch.generation import GenerationConfig, generate_with_kv_cache
    pipe = sides[0]
    z = torch.as_tensor(_latents(4, seed=7))
    with torch.no_grad():
        full = pipe.encoder.heads_from_z(z)
        rolled = generate_with_kv_cache(pipe.decoder, z, full['stoich'], full['heads_vec'],
                                        None, GenerationConfig(max_len=CFG.max_len,
                                                               temperature=0.0))['tokens']
        toks = torch.cat([torch.full((4, 1), BOS_ID), rolled], dim=1)
        tf_argmax = pipe.decoder(z, toks, full['stoich'], full['heads_vec'])['logits'].argmax(-1)
    for b in range(4):
        eos = (rolled[b] == EOS_ID).nonzero()
        end = int(eos[0]) + 1 if len(eos) else rolled.shape[1]
        assert torch.equal(tf_argmax[b, :end], rolled[b, :end])
    assert pipe.decode_latents(z, pure_greedy=True) == [
        pipe.tokenizer.decode(t) for t in rolled.numpy()]


def test_decode_conditioned_equals_jax(sides):
    pipe, jpipe = sides
    rng = np.random.default_rng(4)
    z = _latents(8, seed=13, scale=2.0)
    stoich = rng.random((8, CFG.stoich_input_dim)).astype(np.float32)
    heads_vec = rng.standard_normal((8, CFG.heads_input_dim)).astype(np.float32)
    assert pipe.decode_conditioned(z, stoich, heads_vec) == jpipe.decode_conditioned(
        jnp.asarray(z), jnp.asarray(stoich), jnp.asarray(heads_vec))


# -- run() ----------------------------------------------------------------------

def test_run_equals_jax_with_fed_draws(sides, monkeypatch):
    """The whole pipeline: JAX fed the port's draws (cluster sampling, the
    evolutionary generations) and its MC-dropout Tc; the ranked candidates
    agree."""
    pipe, jpipe = sides
    fed = FedDraws()
    mc = []

    def recorded_mc(*args, **kwargs):
        mc.append(predict_tc_mc(*args, **kwargs))
        return mc[-1]

    monkeypatch.setattr(pdisc, 'predict_tc_mc', recorded_mc)
    with fed.recording():
        got = pipe.run(n_candidates=48, seed=2)
    assert not pipe.encoder.training and not pipe.decoder.training
    fed.feeding(monkeypatch, jlatent, jcg_mod)
    monkeypatch.setattr(jenc_mod, 'predict_tc_mc', lambda *a, **k: tuple(
        jnp.asarray(t.numpy()) for t in mc[0]))
    evolve = jpipe.generator.evolutionary

    def evolve_eagerly(*a, **k):
        with jax.disable_jit():
            return evolve(*a, **k)

    monkeypatch.setattr(jpipe.generator, 'evolutionary', evolve_eagerly)
    want = jpipe.run(n_candidates=48, seed=2)
    assert fed.exhausted()
    assert len(got) == len(want) > 0 and all(isinstance(c, Candidate) for c in got)
    for a, b in zip(got, want):
        assert (a.formula, a.strategy, a.novelty) == (b.formula, b.strategy, b.novelty)
        for f in ('tc_pred_kelvin', 'sc_prob', 'validation_score', 'physics_plausibility',
                  'rank_score', 'tc_uncertainty'):
            assert math.isclose(getattr(a, f), getattr(b, f), rel_tol=1e-5, abs_tol=1e-5), f


def test_analyzer_cache(sides):
    pipe, jpipe = sides
    cache = pipe.analyzer.build_cache(pipe.ds)
    jcache = jpipe.analyzer.build_cache(jpipe.ds)
    assert isinstance(cache, LatentCache) and isinstance(pipe.analyzer, LatentSpaceAnalyzer)
    np.testing.assert_allclose(cache.z, jcache.z, rtol=1e-5, atol=1e-5)
    assert isinstance(pipe.generator, CandidateGenerator)
