"""K1, the decode-step attention: the port's plain version against the JAX
package's XLA reference and its Pallas kernel in interpret mode, at the
main path's widths (H=8, T=30, Dh=72) and a small batch, and at the other
T and Dh the kernel takes (T past 32 slots, Dh up to 256, a Dh that is not
a whole number of 16-byte vectors); and the wrapper's checks of what the
kernel takes.

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

import torch_port_threads  # noqa: F401  (one torch thread a process)

B, H, T, DH = 4, 8, 30, 72


def _inputs(seed, t=T, dh=DH, b=B):
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((b, H, dh)).astype(np.float32) for _ in range(3)]
    caches = [rng.standard_normal((b, H, t, dh)).astype(np.float32) for _ in range(2)]
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


@pytest.mark.parametrize('t,dh,position', [(38, 72, 19), (38, 72, 37), (257, 64, 200),
                                           (30, 256, 29), (30, 66, 7)])
def test_decode_step_attention_matches_jax_any_t_and_dh(t, dh, position):
    """T past one 32-slot tile, Dh up to 256 and a Dh of no whole 16-byte
    vectors, the shapes the kernel was widened to, at B=2."""
    q, kn, vn, kc, vc = _inputs(t + dh + position, t=t, dh=dh, b=2)
    ref_o, ref_k, ref_v = decode_step_attention_xla(
        *map(jnp.asarray, (q, kn, vn, kc, vc)), position)
    pal_o, pal_k, pal_v = jax_kernel(*map(jnp.asarray, (q, kn, vn, kc, vc)),
                                     position, interpret=True)
    k_cache, v_cache = torch.tensor(kc), torch.tensor(vc)
    out = port.decode_step_attention(torch.tensor(q), torch.tensor(kn),
                                     torch.tensor(vn), k_cache, v_cache, position)
    assert out.dtype == torch.float32 and out.shape == (2, H, dh)
    for want in (ref_o, pal_o):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for got, want_x, want_p in ((k_cache, ref_k, pal_k), (v_cache, ref_v, pal_v)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))


def test_decode_step_attention_ref_bf16_matches_jax_past_one_tile():
    """bf16 at bench.py's probe shape (T = max_len + 8 = 38, position 19)."""
    q, kn, vn, kc, vc = _inputs(5, t=38)
    to_j = lambda x: jnp.asarray(x, jnp.bfloat16)
    to_t = lambda x: torch.tensor(x).bfloat16()
    ref_o, _, _ = decode_step_attention_xla(*map(to_j, (q, kn, vn, kc, vc)), 19)
    out = port.decode_step_attention(*map(to_t, (q, kn, vn, kc, vc)), 19)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_o, np.float32),
                               rtol=2 ** -7, atol=1e-3)


def test_check_takes_any_t_and_dh_up_to_256():
    """The wrapper's checks, on CPU tensors: any T, Dh up to 256 in either
    dtype, whole 16-byte vectors or not; Dh 260 and a position past the
    cache are refused."""
    def args(t, dh, dtype=torch.float32):
        return [torch.zeros(2, H, dh, dtype=dtype) for _ in range(3)] + [
            torch.zeros(2, H, t, dh, dtype=dtype) for _ in range(2)]
    for t in (33, 38, 257):
        port._check(*args(t, 72), t - 1)
    for dtype, dh in ((torch.float32, 66), (torch.bfloat16, 70), (torch.float32, 256),
                      (torch.bfloat16, 256), (torch.float32, 4)):
        port._check(*args(30, dh, dtype), 29)
    with pytest.raises(ValueError, match='Dh=260'):
        port._check(*args(30, 260), 0)
    with pytest.raises(ValueError, match='position'):
        port._check(*args(38, 72), 38)
    with pytest.raises(ValueError, match='T > 0'):
        port._check(*args(0, 72), 0)
