"""K1 in bfloat16 on the CPU: the JAX package's Pallas kernel
(``decode_step_attention``, interpret mode) and the port's plain version
(``decode_step_attention_ref``, which the card's kernel is held to) on the
same bf16 inputs of run4's shapes (H=8, T=30, Dh=72), each against the
float64 attention of those inputs.  Both accumulate in float32 and round
the output to bf16 once, so each stays within one bf16 rounding of the
float64 result (2**-8 of its magnitude, and a float32 margin), and the
two differ by at most one bf16 step where a float32 sum lies near a
rounding boundary.  The test prints the distances, which PERF.md records
beside the card's."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.ops.pallas_decode import decode_step_attention as jax_k1
from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention_ref

import torch_port_threads  # noqa: F401  (one torch thread a process)

B, H, T, DH = 16, 8, 30, 72


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _f64_attention(q, k, v, position):
    """float64 attention of the single query over slots <= position."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = np.einsum('bhd,bhtd->bht', q, k[:, :, :position + 1]) / math.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum('bht,bhtd->bhd', p, v[:, :, :position + 1])


@pytest.mark.parametrize('position', [0, 14, 29])
def test_k1_bf16_plain_version_and_pallas_kernel_against_float64(position):
    rng = np.random.default_rng(position)
    q, k_new, v_new = (_bf16(rng.standard_normal((B, H, DH)).astype(np.float32) * 2)
                       for _ in range(3))
    k_cache, v_cache = (_bf16(rng.standard_normal((B, H, T, DH)).astype(np.float32))
                        for _ in range(2))
    as_np = [x.float().numpy() for x in (q, k_new, v_new, k_cache, v_cache)]

    port = decode_step_attention_ref(q, k_new, v_new, k_cache, v_cache, position)
    jout, jk, jv = jax_k1(*(jnp.asarray(x, jnp.bfloat16) for x in as_np), position,
                          interpret=True)
    np.testing.assert_array_equal(np.asarray(jk, np.float32), k_cache.float().numpy())
    np.testing.assert_array_equal(np.asarray(jv, np.float32), v_cache.float().numpy())
    want = _f64_attention(as_np[0], k_cache.float().numpy(), v_cache.float().numpy(), position)

    scale = np.abs(want).max()
    port_err = np.abs(port.double().numpy() - want).max() / scale
    jax_err = np.abs(np.asarray(jout, np.float64) - want).max() / scale
    apart = np.asarray(jout, np.float32) != port.float().numpy()
    step = np.abs(np.asarray(jout, np.float64) - port.double().numpy()).max() / scale
    print(f'K1 bf16 at position {position}: largest error against float64, of the largest '
          f'output: plain version {port_err:.3e}, Pallas kernel (interpret) {jax_err:.3e}; '
          f'{apart.mean():.4%} of outputs a bf16 step apart ({step:.3e})')
    bound = 2.0 ** -8 + 1e-6                  # one bf16 rounding, and float32's sums
    assert port_err <= bound and jax_err <= bound
    assert step <= 2.0 ** -7 and apart.mean() < 0.05
