"""The host-side parts that Phase 2 imports, in the port against the JAX
package on the same inputs: the chemistry tables, ``as_f32``, both
validators, both correctors, the latent samplers, the rational stoich snap,
the coverage tracker and the KL-annealing utilities.

Inputs: the first 2,000 formulas of data/processed/jarvis_merged.csv.gz,
variants of them spelled wrongly for the correctors, and a fixed list of
edge strings; latents, noise and data made with numpy from seeds.

Tolerance: the validators, the correctors, the tables and the coverage
tracker are host code with the same arithmetic on both sides, so their
results must be EQUAL.  The tensor functions (latent.py, stoich_snap.py,
kl_annealing.py) are float32 on both sides with other kernels, so they
agree within 1e-6.  A random function is held through its deterministic
core: the test draws with the JAX function's own key splits and feeds the
draws to the port's core.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.chem import elements as jel
from superconductor_vae_tpu.generation import latent as jlat
from superconductor_vae_tpu.generation.stoich_snap import rational_snap_stoich as jsnap
from superconductor_vae_tpu.postprocessing import formula_corrector as jfc
from superconductor_vae_tpu.postprocessing import fraction_corrector as jfr
from superconductor_vae_tpu.training import coverage_tracker as jcov
from superconductor_vae_tpu.training import kl_annealing as jkl
from superconductor_vae_tpu.utils.npz import as_f32 as jas_f32
from superconductor_vae_tpu.validation import (
    CandidateValidator as JCandidate, PhysicsValidator as JPhysics)
from superconductor_vae_tpu_torch.chem import elements as pel
from superconductor_vae_tpu_torch.data import read_csv_rows
from superconductor_vae_tpu_torch.generation import latent as plat
from superconductor_vae_tpu_torch.generation.stoich_snap import rational_snap_stoich as psnap
from superconductor_vae_tpu_torch.postprocessing import (
    COMMON_DENOMINATORS, FormulaCorrector, FractionCorrector)
from superconductor_vae_tpu_torch.training import coverage_tracker as pcov
from superconductor_vae_tpu_torch.training import kl_annealing as pkl
from superconductor_vae_tpu_torch.utils.npz import as_f32
from superconductor_vae_tpu_torch.validation import CandidateValidator, PhysicsValidator
import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
TOL = dict(rtol=1e-6, atol=1e-6)
EDGE = [
    '', 'Xx2O3', 'Q', 'He', 'ArCu2O4', 'NeFe', 'XeF2', 'FeCu', 'FeCuAgW', 'AgNi3',
    'Cu60O3', 'Nb51', 'LiBeBNaMgAlSiKCaSc', 'LiBeBNaMgAlSiKCa', 'TlF', 'TlBa2CaCu2O7',
    'La(9/5)Sr(1/5)CuO4', 'YBa2Cu3O(13/2)', 'Fe(1/0)Se', 'MgB2', 'H6S', 'LaH10',
    'Nb3Sn', 'V3Si', 'CeCu2Si2', 'UPt3', 'PuCoGa5', 'FeSe', 'LaFeAsO(9/10)F(1/10)',
    'HgBa2Ca2Cu3O8', 'Cs3C60', 'CsF', 'NaCl', 'Pb', 'Al', 'PbAl', 'W(1/2)Cu(1/2)',
    'Fe100', 'O', 'OOO', 'Cu(0/5)O', 'ybacuo', 'YBa2Cu3O7-x', 'Ca(31/100)O3Sr(7/10)Ti',
    '{18}O2Cu', 'FrF', 'Bi2Sr2CaCu2O8', 'K(3/10)Ba(7/10)BiO3', 'BaPb(3/4)Bi(1/4)O3',
]


@pytest.fixture(scope='module')
def formulas():
    return list(read_csv_rows(CSV, 2000)['formula']) + EDGE


def _garbled(formulas):
    """Each formula spelled wrongly in one of the ways the corrector
    repairs: case, stray characters, slashes, slashless and empty
    fractions, unbalanced parentheses, trailing garbage."""
    out = []
    for i, f in enumerate(formulas):
        kind = i % 8
        if kind == 0:
            out.append(f.lower())
        elif kind == 1:
            out.append(f[:len(f) // 2] + ' #' + f[len(f) // 2:])
        elif kind == 2:
            out.append(f.replace('/', '//'))
        elif kind == 3:
            out.append(f.replace('/', ''))
        elif kind == 4:
            out.append(f + '()')
        elif kind == 5:
            out.append('(' + f)
        elif kind == 6:
            out.append(f + ')(' + ')')
        else:
            out.append(f + 'qz9')
    return out


# -- chemistry tables ------------------------------------------------------------

def test_chemistry_tables_equal_jax():
    assert pel._OXIDATION_STATES == jel._OXIDATION_STATES
    symbols = jel.ELEMENT_SYMBOLS[1:] + ['', 'Xx', 'h']
    for s in symbols:
        assert pel.get_oxidation_states(s) == jel.get_oxidation_states(s), s
        assert pel.get_atomic_number(s) == jel.get_atomic_number(s), s
    for z in range(-1, 121):
        assert pel.get_element_symbol(z) == jel.get_element_symbol(z), z
    # a copy: the caller cannot change the table
    pel.get_oxidation_states('Cu').append(9)
    assert pel.get_oxidation_states('Cu') == [1, 2, 3]


@pytest.mark.parametrize('shape', [(5,), (7, 3)])
def test_as_f32_equals_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    bf = x.astype(ml_dtypes.bfloat16)
    raw = np.frombuffer(bf.tobytes(), dtype='V2').reshape(shape)   # as np.load gives it
    assert raw.dtype.kind == 'V'
    np.testing.assert_array_equal(as_f32(raw), jas_f32(raw))
    np.testing.assert_array_equal(as_f32(raw), bf.astype(np.float32))
    for a in (x, x.astype(np.float64), bf):
        got = as_f32(a)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jas_f32(a))


# -- validators and correctors ------------------------------------------------------

def test_candidate_validator_equals_jax(formulas):
    for kw in ({}, dict(charge_tolerance=0.5, max_en_spread=2.0, max_elements=4,
                        max_amount=10.0)):
        port, ref = CandidateValidator(**kw), JCandidate(**kw)
        got = [dataclasses.asdict(r) for r in port.validate_batch(formulas)]
        want = [dataclasses.asdict(r) for r in ref.validate_batch(formulas)]
        assert got == want
    # the edge strings reach every check's failure
    issues = ' '.join(' '.join(r.issues) for r in CandidateValidator().validate_batch(EDGE))
    for word in ('no parseable', 'elements (>', 'out of range', 'noble gas',
                 'forbidden pair', 'charge interval', 'electronegativity spread'):
        assert word in issues, word


def test_physics_validator_equals_jax(formulas):
    for kw in ({}, dict(size_mismatch_limit=0.15, en_diff_limit=1.5)):
        port, ref = PhysicsValidator(**kw), JPhysics(**kw)
        got = [dataclasses.asdict(port.validate(f)) for f in formulas]
        want = [dataclasses.asdict(ref.validate(f)) for f in formulas]
        assert got == want
        stoich = {'Fe': 1.0, 'Cu': 2.0}
        assert (dataclasses.asdict(port.validate('x', stoichiometry=stoich))
                == dataclasses.asdict(ref.validate('x', stoichiometry=stoich)))
    warnings = ' '.join(' '.join(PhysicsValidator().validate(f).warnings) for f in EDGE)
    for word in ('immiscible pair', 'size mismatch', 'dominates', 'empty composition'):
        assert word in warnings, word


def test_formula_corrector_equals_jax(formulas):
    port, ref = FormulaCorrector(), jfc.FormulaCorrector()
    inputs = formulas + _garbled(formulas)
    got = [dataclasses.asdict(r) | {'was': r.was_corrected} for r in port.correct_batch(inputs)]
    want = [dataclasses.asdict(r) | {'was': r.was_corrected} for r in ref.correct_batch(inputs)]
    assert got == want
    kinds = {c for r in got for c in r['corrections']}
    assert {'removed invalid characters', 'fixed multiple slashes', 'removed empty fraction',
            'fixed slashless fraction', 'balanced parentheses', 'fixed element capitalization',
            'truncated garbage'} <= kinds
    assert [port.validate(f) for f in inputs] == [ref.validate(f) for f in inputs]


def test_fraction_corrector_equals_jax(formulas):
    assert COMMON_DENOMINATORS == jfr.COMMON_DENOMINATORS
    rng = np.random.default_rng(3)
    off_grid = [f'Cu({p}/{q})O({r}/{s})' for p, q, r, s in rng.integers(1, 997, (200, 4))]
    inputs = formulas + off_grid + ['La(4/10)Sr(1/10)CuO4', 'A(3/7)B(2/9)C(1/3)',
                                    'Y(1/3)Ba(2/3)(67/100)', 'Fe(1/0)Se(2/4)']
    for kw in ({}, dict(snap_tolerance=0.005, enforce_site_sums=False)):
        port, ref = FractionCorrector(**kw), jfr.FractionCorrector(**kw)
        got = [dataclasses.asdict(port.correct(f)) for f in inputs]
        want = [dataclasses.asdict(ref.correct(f)) for f in inputs]
        assert got == want
        for v in np.linspace(0.001, 3.0, 97):
            assert port._snap_value(float(v)) == ref._snap_value(float(v))
    kinds = ' '.join(c for r in got for c in r['corrections'])
    for word in ('snapped', 'canonicalized', 'zero-denominator'):
        assert word in kinds, word


# -- latent.py ---------------------------------------------------------------------

D = 24


def _z(n, seed):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize('batched', [False, True])
def test_slerp_and_lerp_equal_jax(batched):
    z0, z1 = _z(6, 0), _z(6, 1)
    z1[2] = 3.0 * z0[2]                       # collinear: the linear branch
    ts = np.linspace(0.0, 1.0, 6).astype(np.float32)
    if batched:
        _close(plat.slerp(torch.tensor(z0), torch.tensor(z1), torch.tensor(ts)),
               jax.vmap(jlat.slerp)(z0, z1, ts))
        _close(plat.lerp(torch.tensor(z0), torch.tensor(z1), torch.tensor(ts)),
               jax.vmap(jlat.lerp)(z0, z1, ts))
    else:
        for i, t in enumerate(ts):
            _close(plat.slerp(torch.tensor(z0[i]), torch.tensor(z1[i]), float(t)),
                   jlat.slerp(z0[i], z1[i], float(t)))
            _close(plat.lerp(torch.tensor(z0[i]), torch.tensor(z1[i]), float(t)),
                   jlat.lerp(z0[i], z1[i], float(t)))


@pytest.mark.parametrize('spherical', [True, False])
def test_walks_and_sweeps_equal_jax(spherical):
    z = _z(40, 2)
    _close(plat.interpolation_sweep(torch.tensor(z[0]), torch.tensor(z[1]), 9, spherical),
           jlat.interpolation_sweep(z[0], z[1], 9, spherical))
    steps = np.linspace(-0.5, 1.5, 7).astype(np.float32)
    _close(plat.centroid_walk(torch.tensor(z[0]), torch.tensor(z.mean(0)), torch.tensor(steps)),
           jlat.centroid_walk(z[0], z.mean(0), steps))
    comps, std = plat.pca_components(z, k=5)
    jcomps, jstd = jlat.pca_components(z, k=5)
    np.testing.assert_array_equal(comps, jcomps)
    np.testing.assert_array_equal(std, jstd)
    mags = np.random.default_rng(4).standard_normal((11, 5)).astype(np.float32)
    _close(plat.pca_walk(torch.tensor(z[3]), torch.tensor(comps.astype(np.float32)),
                         torch.tensor(mags)),
           jlat.pca_walk(z[3], comps.astype(np.float32), mags))


def test_jaccard_neighbors_equal_jax():
    rng = np.random.default_rng(5)
    presence = rng.random((300, 119)) < 0.04
    for row in range(5):
        for k, shared in ((32, 2), (8, 1), (400, 3)):
            np.testing.assert_array_equal(
                plat.element_jaccard_neighbors(presence[row], presence, k, shared),
                jlat.element_jaccard_neighbors(presence[row], presence, k, shared))


def test_perturb_core_equals_jax():
    z = _z(10, 6)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, z.shape, jnp.float32))
    _close(plat._perturb(torch.tensor(z), torch.tensor(noise), 0.05),
           jlat.perturb(jnp.asarray(z), key, 0.05))
    gen = torch.Generator().manual_seed(0)
    out = plat.perturb(torch.tensor(z), gen, 0.05)
    assert out.shape == z.shape and 0.04 < float((out - torch.tensor(z)).std()) < 0.06


@pytest.mark.parametrize('n,sigma,slerp_fraction', [(12, 0.05, 0.3), (7, 0.1, 1.0),
                                                    (5, 0.0, 0.0)])
def test_element_anchored_blend_core_equals_jax(n, sigma, slerp_fraction):
    anchor, nbrs = _z(1, 8)[0], _z(16, 9)
    key = jax.random.PRNGKey(n)
    k1, k2, k3 = jax.random.split(key, 3)          # the JAX function's own splits
    idx = np.asarray(jax.random.randint(k1, (n,), 0, len(nbrs)))
    ts = np.asarray(jax.random.uniform(k2, (n,), minval=0.2, maxval=0.8))
    noise = np.asarray(jax.random.normal(k3, (n, D)))
    want = jlat.element_anchored_blend(jnp.asarray(anchor), jnp.asarray(nbrs), key, n,
                                       sigma=sigma, slerp_fraction=slerp_fraction)
    got = plat._blend(torch.tensor(anchor), torch.tensor(nbrs), torch.tensor(idx).long(),
                      torch.tensor(ts), torch.tensor(noise), sigma, slerp_fraction)
    _close(got, want)
    out = plat.element_anchored_blend(torch.tensor(anchor), torch.tensor(nbrs),
                                      torch.Generator().manual_seed(1), n, sigma,
                                      slerp_fraction)
    assert out.shape == (n, D) and bool(torch.isfinite(out).all())


# -- stoich_snap.py -----------------------------------------------------------------

def _stoich_inputs():
    rng = np.random.default_rng(11)
    rows = []
    for _ in range(64):                          # on the grid: a formula's shares
        k = rng.integers(1, 7)
        amounts = rng.integers(1, 9, k).astype(np.float64)
        frac = np.zeros(12)
        frac[:k] = amounts / amounts.sum()
        rows.append(np.concatenate([frac, [k]]))
    grid = np.asarray(rows, np.float32)
    near = grid.copy()
    near[:, :12] += (rng.random((64, 12)) - 0.5).astype(np.float32) * 4e-3 * (grid[:, :12] > 0)
    near[:, 12] += 0.3
    off = rng.random((64, 13)).astype(np.float32)
    off[:, 12] *= 20.0
    zero = np.zeros((2, 13), np.float32)
    zero[1, :12] = 1e-4                          # every slot snaps to zero
    return np.concatenate([grid, near, off, zero])


@pytest.mark.parametrize('tol', [2.5e-3, 1e-2])
def test_rational_snap_equals_jax(tol):
    x = _stoich_inputs()
    got = psnap(torch.tensor(x), tol=tol).numpy()
    _close(got, jsnap(jnp.asarray(x), tol=tol))
    # YBa2Cu3O7's shares (1, 2, 3, 7 of 13) and its count stay as they are
    ybco = torch.tensor([[1 / 13, 2 / 13, 3 / 13, 7 / 13] + [0.0] * 8 + [4.0]])
    torch.testing.assert_close(psnap(ybco), ybco, rtol=0, atol=1e-7)


# -- coverage tracker ----------------------------------------------------------------

def _blobs(n_blobs=6, per=40, d=16, seed=12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_blobs, d)) * 6.0
    return np.concatenate([c + 0.3 * rng.standard_normal((per, d)) for c in centers]
                          ).astype(np.float32)


def _tracker_state(t):
    return {k: getattr(t, k) for k in ('centers', 'visits', 'quality', 'quality_seen')}


def _same_state(a, b):
    for k, v in _tracker_state(a).items():
        np.testing.assert_array_equal(v, _tracker_state(b)[k], err_msg=k)


def _drive(tracker, z, seed=13):
    """assign, two rounds of record_visits (the second with quality), the
    weights and the stats."""
    rng = np.random.default_rng(seed)
    probe = z[rng.choice(len(z), 50)] + 0.1 * rng.standard_normal((50, z.shape[1]))
    out = [tracker.assign(probe, tracker.centers)]
    tracker.record_visits(probe[:20])
    tracker.record_visits(probe, quality=rng.random(50).astype(np.float32))
    out += [tracker.sampling_weights(), tracker.stats(),
            tracker.sample_cluster(np.random.default_rng(seed))]
    return out


@pytest.mark.parametrize('method,no_sklearn', [('kmeans', False), ('hdbscan', False),
                                               ('hdbscan', True)])
def test_coverage_tracker_equals_jax(method, no_sklearn, monkeypatch):
    if no_sklearn:                              # as on a machine without sklearn
        monkeypatch.setitem(sys.modules, 'sklearn.cluster', None)
    z = _blobs()
    for quality_alpha in (1.0, 0.0):
        port = pcov.CoverageTracker(k=8, quality_alpha=quality_alpha)
        ref = jcov.CoverageTracker(k=8, quality_alpha=quality_alpha)
        port.fit(z, method=method)
        ref.fit(z, method=method)
        _same_state(port, ref)
        assert port.fitted_with == ('hdbscan' if method == 'hdbscan' and not no_sklearn
                                    else 'kmeans')
        got, want = _drive(port, z), _drive(ref, z)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]
        _same_state(port, ref)
    if method == 'hdbscan' and not no_sklearn:
        assert len(port.centers) >= 4            # the density path ran, not the fallback


def test_coverage_fit_takes_raw_bf16_and_small_caches():
    z = _blobs(per=8)                            # 48 rows: HDBSCAN is skipped below 64
    raw = np.frombuffer(z.astype(ml_dtypes.bfloat16).tobytes(), dtype='V2').reshape(z.shape)
    port, ref = pcov.CoverageTracker(k=5), jcov.CoverageTracker(k=5)
    port.fit(raw, method='hdbscan')
    ref.fit(raw, method='hdbscan')
    _same_state(port, ref)
    assert port.fitted_with == 'kmeans' and port.centers.dtype == np.float32


# -- kl_annealing.py ------------------------------------------------------------------

@pytest.mark.parametrize('schedule_type', ['cyclical', 'monotonic', 'constant'])
def test_kl_schedule_equals_jax(schedule_type):
    for kw in (dict(), dict(n_epochs=50, n_cycles=3, warmup_epochs=5, cycle_ratio=0.3,
                            min_beta=0.1, max_beta=0.7), dict(n_cycles=0)):
        port = pkl.CyclicalKLScheduler(schedule_type=schedule_type, **kw)
        ref = jkl.CyclicalKLScheduler(schedule_type=schedule_type, **kw)
        np.testing.assert_array_equal(port.get_full_schedule(), ref.get_full_schedule())
    with pytest.raises(ValueError):
        pkl.CyclicalKLScheduler(schedule_type='nope').get_beta(50)


@pytest.mark.parametrize('free_bits', [False, True])
def test_kl_losses_equal_jax(free_bits):
    rng = np.random.default_rng(14)
    mu = rng.standard_normal((8, 16)).astype(np.float32)
    logvar = (0.5 * rng.standard_normal((8, 16))).astype(np.float32)
    tm, tl = torch.tensor(mu), torch.tensor(logvar)
    _close(pkl.kl_loss(tm, tl), jkl.kl_loss(mu, logvar))
    _close(pkl.kl_loss_free_bits(tm, tl, 0.3), jkl.kl_loss_free_bits(mu, logvar, 0.3))
    port = pkl.KLLossWithAnnealing(n_epochs=40, use_free_bits=free_bits, free_bits=0.2)
    ref = jkl.KLLossWithAnnealing(n_epochs=40, use_free_bits=free_bits, free_bits=0.2)
    for epoch in (0, 12, 27):
        got, want = port(tm, tl, epoch), ref(mu, logvar, epoch)
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert got[2] == want[2]
