"""K2, the flash-attention forward, and its dispatcher: the port's plain
version against the JAX package's Pallas kernel in interpret mode and its
XLA reference, at the shapes of tests/test_pallas.py (B=2, H=2).

Tolerance: float32 throughout; the kernel, the einsum reference and the
plain version sum in other orders, so outputs agree to 2e-5 absolute and
relative, the tolerance of tests/test_pallas.py.  The dispatch to the
plain attention below T=128 gives the same einsum, to 1e-6, and so does
the zero padding of a ragged Dh (the einsum sums zeros more).  In bfloat16
(Dh up to 256, as in float32) both round the probabilities to bf16 before
P.V, against the running max of 128-key tiles
(Pallas) or the final max (plain), and round the output once: two bf16 ulp
(2**-6 relative) plus 2e-3 absolute, chip_smoke.py's K2_TOL['bfloat16'];
the largest difference seen on the CPU is 3.9e-3 at T=256, Dh=200 (0.37
of the tolerance there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_vae_tpu.ops.attention import causal_mask as jax_causal_mask
from superconductor_vae_tpu.ops.attention import mha_attention as jax_mha
from superconductor_vae_tpu.ops.pallas_attention import (
    fused_attention as jax_fused, pallas_attention)
from superconductor_vae_tpu_torch.ops import fused_attention as port
from superconductor_vae_tpu_torch.ops.attention import causal_mask, mha_attention

import torch_port_threads  # noqa: F401  (one torch thread a process)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -6, atol=2e-3)


def _qkv(b, t, h, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize('t,dh', [(128, 64), (256, 72), (128, 128), (100, 72),
                                  (128, 200), (256, 200), (128, 256), (256, 256)])
def test_flash_attention_ref_matches_pallas(t, dh):
    """float32 up to the kernel's Dh cap of 256 (the Pallas kernel pads 200
    to 256)."""
    q, k, v = _qkv(2, t, 2, dh, seed=t + dh)
    want_pallas = pallas_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                   interpret=True)
    want_xla = jax_mha(*map(jnp.asarray, (q, k, v)), jax_causal_mask(t))
    before = port.flash_attention.launches
    got = port.flash_attention(*map(torch.tensor, (q, k, v)))
    assert port.flash_attention.launches == before      # the CPU runs the plain version
    assert got.shape == (2, t, 2, dh) and got.dtype == torch.float32
    for want in (want_pallas, want_xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_false_is_still_causal():
    """Both kernels apply the causal predicate whatever ``causal`` says."""
    q, k, v = _qkv(2, 128, 2, 64, seed=3)
    causal = pallas_attention(*map(jnp.asarray, (q, k, v)), causal=True, interpret=True)
    not_causal = pallas_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                  interpret=True)
    np.testing.assert_array_equal(np.asarray(not_causal), np.asarray(causal))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = port.flash_attention(tq, tk, tv, causal=False)
    torch.testing.assert_close(got, port.flash_attention(tq, tk, tv, causal=True),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(causal), **TOL)
    full = mha_attention(tq, tk, tv)                   # what a non-causal call would be
    assert not torch.allclose(got, full, **TOL)


def test_dispatch_below_min_len_is_mha():
    """T=16 < MIN_PALLAS_LEN: the plain attention with the causal mask, in
    both packages (tests/test_pallas.py::test_dispatch_small_uses_xla)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
    k, v = q + 1.0, q - 1.0
    want = jax_fused(*map(jnp.asarray, (q, k, v)), causal=True)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    before = port.flash_attention.launches
    got = port.fused_attention(tq, tk, tv, causal=True)
    assert port.flash_attention.launches == before
    torch.testing.assert_close(got, mha_attention(tq, tk, tv, causal_mask(16)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # at T >= 128 on the CPU the dispatcher still takes the plain attention
    q2, k2, v2 = map(torch.tensor, _qkv(1, 128, 2, 32, seed=5))
    torch.testing.assert_close(port.fused_attention(q2, k2, v2, causal=True),
                               mha_attention(q2, k2, v2, causal_mask(128)),
                               rtol=0, atol=0)
    # forced, the kernel's branch runs: the plain version on the CPU
    forced = port.fused_attention(q2, k2, v2, force_pallas=True)
    torch.testing.assert_close(forced, port.flash_attention_ref(q2, k2, v2),
                               rtol=0, atol=0)


def test_wrapper_refuses_cross_attention_and_grad():
    q, k, v = map(torch.tensor, _qkv(1, 32, 2, 16, seed=4))
    with pytest.raises(ValueError, match='self-attention only'):
        port.flash_attention(q, k[:, :24], v[:, :24])
    with pytest.raises(ValueError, match='self-attention only'):
        port.fused_attention(q, k[:, :24], v[:, :24], force_pallas=True)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match='no gradient'):
        port.flash_attention(q, k, v)
    with torch.no_grad():                               # no gradient asked for
        out = port.flash_attention(q, k, v)
    assert not out.requires_grad


@pytest.mark.parametrize('t,dh', [(128, 256), (100, 72), (256, 200)])
def test_flash_attention_ref_matches_pallas_bf16(t, dh):
    """bfloat16, up to the bfloat16 kernel's Dh cap of 256 (the Pallas
    kernel pads Dh to 256 for 200)."""
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _qkv(2, t, 2, dh, seed=t + dh)))
    want = pallas_attention(q, k, v, causal=True, interpret=True).astype(jnp.float32)
    before = port.flash_attention.launches
    got = port.flash_attention(*(torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
                                 for x in (q, k, v)))
    assert port.flash_attention.launches == before
    assert got.shape == (2, t, 2, dh) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **BF16_TOL)


def test_check_caps_dh_per_dtype():
    """The kernel's input check: Dh up to 256 in both dtypes, always a whole
    number of 16-byte vectors (the wrapper pads a ragged Dh first)."""
    def qkv(dh, dtype):
        return [torch.zeros(1, 4, 2, dh, dtype=dtype) for _ in range(3)]
    for dh in (8, 72, 256):
        port._check(*qkv(dh, torch.bfloat16))
    for dh in (4, 72, 128, 136, 256):
        port._check(*qkv(dh, torch.float32))
    for dh, dtype in ((264, torch.bfloat16), (260, torch.float32),
                      (12, torch.bfloat16), (6, torch.float32)):
        with pytest.raises(ValueError, match='16-byte vectors'):
            port._check(*qkv(dh, dtype))


@pytest.mark.parametrize('dh', [66, 70])
def test_run_padded_matches_unpadded(dh):
    """The wrapper's padding of a ragged Dh, run with the plain version: Dh
    zero-padded to a whole number of 16-byte vectors (68 or 72 in float32),
    the scale of the real Dh, the output sliced back; it gives the unpadded
    result to 1e-6."""
    q, k, v = map(torch.tensor, _qkv(2, 130, 2, dh, seed=dh))
    seen = []

    def attn(q, k, v, scale):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return port.flash_attention_ref(q, k, v, scale)
    got = port.run_padded(attn, q, k, v)
    dh_p = dh + (-dh % 4)
    assert seen == [(dh_p, dh_p, dh_p, 1.0 / np.sqrt(dh))]
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, port.flash_attention_ref(q, k, v), rtol=1e-6, atol=1e-6)
    # a whole number of vectors is passed through as it is
    q8, k8, v8 = (x[..., :64].contiguous() for x in (q, k, v))
    port.run_padded(attn, q8, k8, v8)
    assert seen[-1] == (64, 64, 64, 1.0 / np.sqrt(64))
