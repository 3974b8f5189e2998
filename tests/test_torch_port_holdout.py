"""The port's generative holdout search (generation/holdout_search.py)
against the JAX package, part by part (tests/test_torch_port_holdout_search.py
holds search() itself and the CLIs), at tiny widths (magpie_dim 78) on the corpus's first
2,000 rows, from the same numpy parameters (``params_from_jax``).

Random draws cannot match across frameworks, so where a function draws
the port's draws are recorded and fed to JAX (``FedDraws``), and JAX's
sampled-temperature decodes return the port's formulas; everything
deterministic (the pools' structure, the ridge, the descents, greedy
decodes, scoring and the tier logic) is JAX's own.  JAX's descent
objectives are read from its jitted closures, so that the gradients are
the JAX package's.  No JAX file changes.

Tolerance: the host functions, token ids, type masks, anchors, formulas
and search outcomes are equal; gradients with respect to z within 1e-5
of their largest component; the pools within 1e-5; the descents' snapshots within 1e-4
(24 Adam steps, float32 on both sides); the inversion diagnostics within
1e-4 relative.  Where predicted fractions tie exactly the sorted
(``order_free``) objective may route its gradient differently; no tie
occurs on these inputs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superconductor_vae_tpu.generation.holdout_search as jhs
import superconductor_vae_tpu.generation.latent as jlatent
from superconductor_vae_tpu_torch.generation import holdout_search as phs
import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import FedDraws
from torch_port_holdout_common import CFG, POOL_TOL, SNAP_TOL, STEPS, make_sides


@pytest.fixture(scope='module')
def sides():
    """(port search, JAX search, port cache, trees) on the same weights and rows."""
    return make_sides()


def _close_rel(got, want, rel=1e-5):
    """Equal within ``rel`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _jax_objective(jsearch, key):
    """The ``obj`` closed over by JAX's jitted descent cached at ``key``."""
    run = jsearch._jit_cache[key]
    fn = run.__wrapped__
    return dict(zip(fn.__code__.co_freevars, fn.__closure__))['obj'].cell_contents


# -- host functions -----------------------------------------------------------------

def test_host_helpers_equal(sides):
    search, jsearch, _, _ = sides
    targets = search.targets
    formulas = search.pipe.ds.formulas[:60] + ['', 'Xx', 'YBa2Cu3O7', 'Cu(1/2)']
    np.testing.assert_array_equal(phs.element_presence(targets + formulas[:-2]),
                                  jhs.element_presence(targets + formulas[:-2]))
    np.testing.assert_array_equal(search.presence, jsearch.presence)
    for f in targets + formulas:
        a, b = phs.composition_feature(f), jhs.composition_feature(f)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), f
    for t in targets:
        for f in formulas + targets[:5]:
            assert phs.element_similarity(t, f) == jhs.element_similarity(t, f), (t, f)


def test_target_arrays_token_ids_and_masks_equal(sides):
    search, jsearch, _, _ = sides
    n_ids = 0
    for t in search.targets:
        for a, b in zip(search._target_head_arrays(t), jsearch._target_head_arrays(t)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=t)
        ids, jids = search._target_token_ids(t), jsearch._target_token_ids(t)
        assert (ids is None) == (jids is None), t
        if ids is not None:
            np.testing.assert_array_equal(ids, jids)
            n_ids += 1
        np.testing.assert_array_equal(search._element_type_masks(t),
                                      np.asarray(jsearch._element_type_masks(t)))
    assert n_ids > 30


def test_anchor_latents_equal(sides):
    search, jsearch, cache, _ = sides
    for t in search.targets:
        for n in (4, 16):
            np.testing.assert_array_equal(search._anchor_latents(t, cache, n=n).numpy(),
                                          np.asarray(jsearch._anchor_latents(t, cache, n=n)))


# -- the descents -------------------------------------------------------------------

def test_torch_adam_is_optax_adam():
    """The descents' optimiser: torch's Adam at its defaults takes optax's
    ``adam(lr)`` steps (b1 0.9, b2 0.999, eps 1e-8 outside the root), in
    float64 so that rounding does not hide a difference of formula."""
    import optax
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 5))
    z0 = rng.standard_normal((4, 5))

    def loss(z, a):
        return ((z @ a.T) ** 2).sum() + (z ** 4).sum()

    z = torch.tensor(z0, requires_grad=True)
    opt = torch.optim.Adam([z], lr=0.05)
    with jax.enable_x64(True):
        tx = optax.adam(0.05)
        jz = jnp.asarray(z0)
        state = tx.init(jz)
        for _ in range(30):
            z.grad = torch.autograd.grad(loss(z, torch.as_tensor(a)), z)[0]
            opt.step()
            upd, state = tx.update(jax.grad(loss)(jz, jnp.asarray(a)), state, jz)
            jz = optax.apply_updates(jz, upd)
        assert jz.dtype == jnp.float64
        np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), rtol=1e-12, atol=1e-12)
    assert np.abs(np.asarray(jz) - z0).max() > 0.5


@pytest.mark.parametrize('order_free', [False, True])
def test_head_guided_latents_equal(sides, order_free):
    search, jsearch, cache, _ = sides
    enc = search.pipe.encoder
    enc.train()                                     # the descent runs it in eval mode
    for t in search.targets[:2]:
        z0 = search._anchor_latents(t, cache, n=4)
        got = search.head_guided_latents(t, z0, steps=STEPS, order_free=order_free)
        want = jsearch.head_guided_latents(t, jnp.asarray(z0.numpy()), steps=STEPS,
                                           order_free=order_free)
        assert got.shape == (16, CFG.latent_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SNAP_TOL)
        assert np.abs(got.numpy()[-4:] - z0.numpy()).max() > 0.1    # it moved
        # the first gradient, JAX's own objective
        arrays = search._guided_arrays(t, order_free)
        z = z0.clone().requires_grad_(True)
        with phs.eval_mode(enc):
            g = torch.autograd.grad(search._guided_objective(z, z0, arrays, 2e-3, order_free),
                                    z)[0]
        obj = _jax_objective(jsearch, ('guided', 4, STEPS, 4, order_free, 0.08, 2e-3))
        jarrays = [jnp.asarray(a.numpy()) for a in arrays]
        jg = jax.jit(jax.grad(obj))(jnp.asarray(z0.numpy()), jnp.asarray(z0.numpy()), *jarrays)
        _close_rel(g.numpy(), jg)
    assert enc.training and all(p.grad is None for p in enc.parameters())
    enc.eval()


def test_decoder_inversion_latents_equal(sides):
    search, jsearch, cache, trees = sides
    for t in search.targets[1:2]:
        z0 = search._anchor_latents(t, cache, n=4)
        got = search.decoder_inversion_latents(t, z0, steps=STEPS)
        diag = dict(search.last_inversion_diag)
        want = jsearch.decoder_inversion_latents(t, jnp.asarray(z0.numpy()), steps=STEPS)
        assert got.shape == (24, CFG.latent_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SNAP_TOL)
        jdiag = jsearch.last_inversion_diag
        assert diag['tf_argmax_full'] == jdiag['tf_argmax_full']
        for k in ('tf_ce_min', 'tf_argmax_max'):
            assert math.isclose(diag[k], jdiag[k], rel_tol=1e-4), (k, diag[k], jdiag[k])
        # the first gradient, JAX's own objective
        ids = search._target_token_ids(t)
        toks = search._inversion_tokens(ids, 4)
        z = z0.clone().requires_grad_(True)
        with phs.eval_mode(search.pipe.encoder, search.pipe.decoder):
            g = torch.autograd.grad(search._inversion_objective(z, z0, toks, 1e-3, 0.25), z)[0]
        obj = _jax_objective(jsearch, ('inversion', 4, STEPS, 6, 0.05, 1e-3))
        zj = jnp.asarray(z0.numpy())
        jg = jax.jit(jax.grad(obj, argnums=2))(trees[0], trees[1], zj, zj,
                                      jnp.asarray(toks.numpy().astype(np.int32)))
        _close_rel(g.numpy(), jg)
    assert search._target_token_ids('Xx') is None
    assert search.decoder_inversion_latents('Xx', z0) is None
    assert all(p.grad is None for m in (search.pipe.encoder, search.pipe.decoder)
               for p in m.parameters())


# -- the pools ------------------------------------------------------------------------

@pytest.mark.parametrize('budget, picks', [(48, (5,)), (200, (0,)), (1024, (1,))])
def test_candidate_latents_equal_with_fed_draws(sides, budget, picks, monkeypatch):
    """Each block's size and order and the values, JAX fed the port's
    draws.  Of the targets, 0 has one row of its element set in the rows,
    1 has 24, and 5 has none and an anchor that lacks two of its elements
    (the dopant blends)."""
    search, jsearch, cache, _ = sides
    fed = FedDraws()
    targets = [search.targets[i] for i in picks]
    with fed.recording():
        pools = [search._candidate_latents(t, cache, budget, torch.Generator().manual_seed(i))
                 for i, t in enumerate(targets)]
    fed.feeding(monkeypatch, jhs, jlatent)
    for i, (t, pool) in enumerate(zip(targets, pools)):
        want = np.asarray(jsearch._candidate_latents(t, cache, budget, jax.random.PRNGKey(i)))
        assert pool.shape == want.shape == (budget, CFG.latent_dim)
        np.testing.assert_allclose(pool.numpy(), want, **POOL_TOL)
    assert fed.exhausted()


def test_inverse_regression_equal_with_fed_draws(sides, monkeypatch):
    search, jsearch, cache, _ = sides
    fed = FedDraws()
    formulas = search.pipe.ds.formulas
    pool_z = [cache.z[:200], cache.z[200:400]]
    by_formula = {}
    for i in range(400):
        by_formula.setdefault(formulas[i % 150], []).append(i)
    t = search.targets[1]
    with fed.recording():
        got = search._inverse_regression_latents(t, pool_z, by_formula,
                                                 torch.Generator().manual_seed(0),
                                                 best=formulas[3])
        thin = search._inverse_regression_latents(t, pool_z, dict(list(by_formula.items())[:5]),
                                                  torch.Generator())
    fed.feeding(monkeypatch, jhs, jlatent)
    want = jsearch._inverse_regression_latents(t, pool_z, by_formula, jax.random.PRNGKey(0),
                                               best=formulas[3])
    assert got.shape == (380, CFG.latent_dim) and thin is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)
    assert fed.exhausted()


# -- oracle and consistency ---------------------------------------------------------

def test_oracle_and_consistency_equal(sides):
    search, jsearch, cache, _ = sides
    for t in search.targets[::20]:
        for masks in (None, search._element_type_masks(t)):
            f, z = search.oracle_reconstruct(t, type_masks=masks)
            jf, jz = jsearch.oracle_reconstruct(
                t, type_masks=None if masks is None else jnp.asarray(masks))
            assert f == jf, t
            np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(search.oracle_encode_latent(t).numpy(),
                               np.asarray(jsearch.oracle_encode_latent(t)), rtol=1e-5, atol=1e-5)
    assert search.oracle_reconstruct('') is None
    c, jc = search.consistency_check(cache.z[:64]), jsearch.consistency_check(
        jnp.asarray(cache.z[:64]))
    for k in ('sc_tc_mismatch', 'sc_family_mismatch', 'tc_bucket_mismatch'):
        np.testing.assert_array_equal(c[k], np.asarray(jc[k]), err_msg=k)
    for k in ('tc_pred_kelvin', 'sc_prob'):
        np.testing.assert_allclose(c[k], np.asarray(jc[k]), rtol=1e-5, atol=1e-5)
