"""K1, the decode-step attention: the port's plain version against the JAX
package's XLA reference and its Pallas kernel in interpret mode, at the
main path's widths (H=8, T=30, Dh=72) and a small batch.

Tolerance: float32 throughout; the three compute the same sums in other
orders, so outputs agree to 1e-6 absolute / 1e-5 relative.  The cache
rows are copies and must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.ops.pallas_decode import (
    decode_step_attention as jax_kernel, decode_step_attention_xla)
from superconductor_vae_tpu_torch.ops import decode_attention as port

B, H, T, DH = 4, 8, 30, 72


def _inputs(seed):
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((B, H, DH)).astype(np.float32) for _ in range(3)]
    caches = [rng.standard_normal((B, H, T, DH)).astype(np.float32) for _ in range(2)]
    return rows + caches


@pytest.mark.parametrize('position', [0, 14, 29])
def test_decode_step_attention_ref_matches_jax(position):
    q, kn, vn, kc, vc = _inputs(position)
    ref_o, ref_k, ref_v = decode_step_attention_xla(
        *map(jnp.asarray, (q, kn, vn, kc, vc)), position)
    pal_o, pal_k, pal_v = jax_kernel(*map(jnp.asarray, (q, kn, vn, kc, vc)),
                                     position, interpret=True)
    k_cache, v_cache = torch.tensor(kc), torch.tensor(vc)
    before = port.decode_step_attention.launches
    out = port.decode_step_attention(torch.tensor(q), torch.tensor(kn),
                                     torch.tensor(vn), k_cache, v_cache, position)
    # the CPU path is the plain version: no kernel launch is counted
    assert port.decode_step_attention.launches == before
    assert out.dtype == torch.float32 and out.shape == (B, H, DH)
    for want in (ref_o, pal_o):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # caches were updated in place, row `position` only
    for got, want_x, want_p in ((k_cache, ref_k, pal_k), (v_cache, ref_v, pal_v)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(k_cache[:, :, position].numpy(), kn)


def test_decode_step_attention_ref_bf16_matches_jax():
    """bf16 caches as in training dtype: float32 accumulation in both, one
    rounding of the output to bf16 (so 1 bf16 ulp, 2**-7 relative)."""
    q, kn, vn, kc, vc = _inputs(3)
    to_j = lambda x: jnp.asarray(x, jnp.bfloat16)
    to_t = lambda x: torch.tensor(x).bfloat16()
    ref_o, _, _ = decode_step_attention_xla(*map(to_j, (q, kn, vn, kc, vc)), 14)
    out = port.decode_step_attention_ref(*map(to_t, (q, kn, vn, kc, vc)), 14)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_o, np.float32),
                               rtol=2 ** -7, atol=1e-3)


def test_decode_step_attention_rejects_mixed_devices():
    q, kn, vn, kc, vc = map(torch.tensor, _inputs(4))
    with pytest.raises(ValueError):
        port.decode_step_attention(q, kn, vn, kc.to('meta'), vc, 0)
