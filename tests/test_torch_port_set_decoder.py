"""The set decoder and its Hungarian matching in the port against the JAX
package (ops/hungarian.py, models/set_decoder.py).

- ``hungarian_assignment``: its optimal cost equals scipy's
  ``linear_sum_assignment`` on random 12 x 12 costs, with and without
  padded columns (1e-5 relative), and its permutation equals JAX's
  ``batched_hungarian``'s exactly, on random costs and on integer costs
  full of ties (first-index tie-breaking); an all-equal cost gives the
  permutation the first-index rule predicts.
- ``SetFormulaDecoder`` on the same numpy parameters as flax's, in float32
  (1e-5 absolute and relative) and in bf16 compute (within min(3 x JAX's
  own bf16-vs-float32 gap, 2**-4 of the largest value), and unequal to the
  port's float32), with the flax tree loaded through ``set_decoder_from_jax``.
- ``hungarian_matching_loss``: every output and its gradients with respect
  to the element logits, fractions and presence logits (1e-5 relative
  plus 1e-6 of the largest gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from superconductor_vae_tpu.models.set_decoder import SetFormulaDecoder as JaxSetDecoder
from superconductor_vae_tpu.ops.hungarian import batched_hungarian
from superconductor_vae_tpu.ops.hungarian import hungarian_matching_loss as jax_matching_loss
from superconductor_vae_tpu_torch.checkpoint import set_decoder_from_jax
from superconductor_vae_tpu_torch.models import SetFormulaDecoder
from superconductor_vae_tpu_torch.ops.hungarian import (
    PAD_COST, hungarian_assignment, hungarian_matching_loss)
import torch_port_threads  # noqa: F401  (one torch thread a process)
from test_torch_port_bf16 import held
from torch_port_common import set_param_tree

N = 12
LATENT = 64
SET_KW = dict(d_model=32, num_layers=2, dim_feedforward=64)      # 8 heads of 4


def _costs(b, seed, n_real=None):
    """[b, 12, 12] uniform costs; with ``n_real`` (per row) the columns
    from it on are padded, as the matching loss pads them."""
    rng = np.random.default_rng(seed)
    cost = rng.random((b, N, N)).astype(np.float32)
    if n_real is not None:
        cost[np.broadcast_to(np.arange(N)[None, None, :] >= n_real[:, None, None],
                             cost.shape)] = PAD_COST
    return cost


@pytest.mark.parametrize('padded', [False, True])
def test_hungarian_cost_is_scipy_optimal(padded):
    b = 24
    n_real = np.random.default_rng(7).integers(1, N + 1, b) if padded else None
    cost = _costs(b, seed=3, n_real=n_real)
    perm, total = hungarian_assignment(torch.as_tensor(cost))
    perm, total = perm.numpy(), total.numpy()
    assert perm.dtype == np.int64 and perm.shape == (b, N)
    for i in range(b):
        rows, cols = linear_sum_assignment(cost[i])
        want = cost[i][rows, cols].astype(np.float64).sum()
        assert sorted(perm[i].tolist()) == list(range(N))
        got = cost[i][np.arange(N), perm[i]].astype(np.float64).sum()
        np.testing.assert_allclose([total[i], got], want, rtol=1e-5)


@pytest.mark.parametrize('kind', ['uniform', 'integer_ties', 'all_equal'])
def test_hungarian_permutation_equals_jax(kind):
    rng = np.random.default_rng(11)
    b = 32
    if kind == 'uniform':
        cost = _costs(b, seed=5, n_real=rng.integers(1, N + 1, b))
    elif kind == 'integer_ties':
        cost = rng.integers(0, 3, (b, N, N)).astype(np.float32)
    else:
        cost = np.zeros((b, N, N), np.float32)
    want_perm, want_total = jax.jit(batched_hungarian)(jnp.asarray(cost))
    perm, total = hungarian_assignment(torch.as_tensor(cost))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    np.testing.assert_array_equal(total.numpy(), np.asarray(want_total))
    if kind == 'all_equal':
        # each level keeps the lowest column of its subset, so the backtrack
        # from the full set assigns column 0 to the last row, and so on
        np.testing.assert_array_equal(perm.numpy(), np.tile(np.arange(N)[::-1], (b, 1)))


@pytest.fixture(scope='module')
def set_trees():
    return set_param_tree(LATENT, seed=2, **SET_KW)


def _z(b, seed=4):
    return np.random.default_rng(seed).standard_normal((b, LATENT)).astype(np.float32)


def test_set_decoder_matches_flax_in_float32(set_trees):
    z = _z(6)
    want = jax.jit(JaxSetDecoder(latent_dim=LATENT, **SET_KW).apply)(set_trees, z)
    port = set_decoder_from_jax(jax.tree.map(np.asarray, set_trees), device='cpu')
    assert port.num_layers == 2 and port.n_z_tokens == 4 and not port.training
    with torch.no_grad():
        got = port(torch.as_tensor(z))
    assert got['element_logits'].shape == (6, N, 119)
    for k in ('element_logits', 'fraction_pred', 'presence_logits'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert (got['fraction_pred'] >= 0).all()


def test_set_decoder_matches_flax_in_bf16(set_trees):
    z = _z(6, seed=8)
    want = {name: jax.jit(JaxSetDecoder(latent_dim=LATENT, dtype=jdt, **SET_KW).apply)(
        set_trees, z) for name, jdt in (('f32', jnp.float32), ('bf16', jnp.bfloat16))}
    got = {}
    for name, tdt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        port = set_decoder_from_jax(jax.tree.map(np.asarray, set_trees), device='cpu',
                                    dtype=tdt)
        with torch.no_grad():
            got[name] = port(torch.as_tensor(z))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    for k in ('element_logits', 'fraction_pred', 'presence_logits'):
        assert got['bf16'][k].dtype == torch.bfloat16, k
        held(got['bf16'][k], got['f32'][k], want['bf16'][k], want['f32'][k], k)


def _matching_inputs(b, seed):
    rng = np.random.default_rng(seed)
    n_el = rng.integers(1, N + 1, b)
    mask = np.arange(N)[None, :] < n_el[:, None]
    frac = rng.random((b, N)).astype(np.float32) * mask
    return (rng.standard_normal((b, N, 119)).astype(np.float32) * 2,
            np.abs(rng.standard_normal((b, N))).astype(np.float32) * 0.3,
            rng.standard_normal((b, N)).astype(np.float32),
            (rng.integers(1, 119, (b, N)) * mask).astype(np.int32),
            (frac / frac.sum(1, keepdims=True)).astype(np.float32), mask)


def test_matching_loss_and_gradients_match_jax():
    logits, frac, pres, gt_e, gt_f, gt_m = _matching_inputs(16, seed=9)
    kw = dict(element_weight=1.0, fraction_weight=5.0, no_object_weight=0.1,
              presence_weight=1.0)

    def jax_total(lo, fr, pr):
        out = jax_matching_loss(lo, fr, pr, gt_e, gt_f, gt_m, **kw)
        return out['total'], out
    (_, want), want_g = jax.jit(jax.value_and_grad(jax_total, argnums=(0, 1, 2),
                                                   has_aux=True))(logits, frac, pres)
    args = [torch.tensor(x, requires_grad=True) for x in (logits, frac, pres)]
    got = hungarian_matching_loss(*args, torch.as_tensor(gt_e).long(), torch.as_tensor(gt_f),
                                  torch.as_tensor(gt_m), **kw)
    got['total'].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), np.asarray(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert 0 < want['element_accuracy'] < 1
    for name, a, w in zip(('element_logits', 'fraction_pred', 'presence_logits'), args, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)


def test_matching_loss_of_a_perfect_prediction_is_small():
    """The JAX test's case: predictions that name every element and
    fraction in shuffled slot order give a near-zero loss and set_exact 1."""
    b = 2
    gt_e = np.zeros((b, N), np.int64)
    gt_f = np.zeros((b, N), np.float32)
    gt_m = np.zeros((b, N), bool)
    gt_e[0, :4], gt_f[0, :4], gt_m[0, :4] = [39, 56, 29, 8], [1, 2, 3, 7], True
    gt_e[1, :2], gt_f[1, :2], gt_m[1, :2] = [12, 5], [1, 2], True
    order = np.roll(np.arange(N), 3)
    logits = np.full((b, N, 119), -10.0, np.float32)
    frac = np.zeros((b, N), np.float32)
    pres = np.full((b, N), -10.0, np.float32)
    for i in range(b):
        for slot, col in enumerate(order):
            logits[i, slot, gt_e[i, col] if gt_m[i, col] else 0] = 10.0
            if gt_m[i, col]:
                frac[i, slot], pres[i, slot] = gt_f[i, col], 10.0
    out = hungarian_matching_loss(*map(torch.as_tensor, (logits, frac, pres, gt_e, gt_f, gt_m)))
    assert out['total'].item() < 1e-3
    assert out['set_exact'].item() == 1.0 and out['element_accuracy'].item() == 1.0


def test_set_decoder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        SetFormulaDecoder()
