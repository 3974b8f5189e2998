"""``mha_attention`` and ``causal_mask``: the port against the JAX package.

Tolerance: float32; einsum and softmax in other summation orders agree to
1e-6 absolute / 1e-5 relative at these sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.ops.attention import causal_mask as jax_causal
from superconductor_vae_tpu.ops.attention import mha_attention as jax_mha
from superconductor_vae_tpu_torch.ops.attention import causal_mask, mha_attention

import torch_port_threads  # noqa: F401  (one torch thread a process)


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(causal_mask(7).numpy(), np.asarray(jax_causal(7)))


@pytest.mark.parametrize('mask_kind', ['none', 'causal', 'prefix'])
def test_mha_attention_matches_jax(mask_kind):
    rng = np.random.default_rng(0)
    b, tq, tk, h, dh = 3, 29, 29, 8, 72
    if mask_kind == 'prefix':        # one decode step over a partly written cache
        tq, tk = 1, 30
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for t in (tq, tk, tk))
    if mask_kind == 'none':
        jm = tm = None
    elif mask_kind == 'causal':
        jm, tm = jax_causal(tq), causal_mask(tq)
    else:
        keep = np.arange(tk)[None, None, None, :] <= 11
        jm, tm = jnp.asarray(keep), torch.tensor(keep)
    want = jax_mha(*map(jnp.asarray, (q, k, v)), jm)
    got = mha_attention(*map(torch.tensor, (q, k, v)), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_fully_masked_row_is_uniform_as_in_jax():
    """finfo.min, not -inf: a row with every key masked averages V."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 2, 8)).astype(np.float32) for _ in range(3))
    keep = np.zeros((1, 1, 2, 2), bool)
    want = jax_mha(*map(jnp.asarray, (q, k, v)), jnp.asarray(keep))
    got = mha_attention(*map(torch.tensor, (q, k, v)), torch.tensor(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0, 0].numpy(), v[0].mean(axis=0), rtol=1e-5, atol=1e-6)
