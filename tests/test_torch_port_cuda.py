"""K1 on the card: the CUDA kernel against its plain PyTorch version.

Needs an NVIDIA GPU and nvcc, and imports no JAX, so that it runs on a
machine with the card only:
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
Elsewhere every test skips.

Tolerance: float32 output 1e-5 absolute and relative (other summation
order); bfloat16 output one bf16 ulp (2**-7 relative) plus 1e-3
absolute, since both round a float32 result once.  Cache rows are copies
and must be equal exactly.
"""

import pytest
import torch

from superconductor_vae_tpu_torch.ops.decode_attention import (
    decode_step_attention, decode_step_attention_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(dev, b, t, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = [torch.randn(b, 8, 72, generator=g, device=dev).to(dtype) for _ in range(3)]
    caches = [torch.randn(b, 8, t, 72, generator=g, device=dev).to(dtype) for _ in range(2)]
    return rows + caches


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,t,position', [(1, 1, 0), (3, 30, 0), (5, 30, 17),
                                          (256, 30, 29), (2, 32, 31)])
def test_kernel_matches_plain_version(cuda, dtype, b, t, position):
    q, kn, vn, kc, vc = _inputs(cuda, b, t, dtype, seed=position)
    kc_ref, vc_ref = kc.clone(), vc.clone()
    before = decode_step_attention.launches
    out = decode_step_attention(q, kn, vn, kc, vc, position)
    ref = decode_step_attention_ref(q, kn, vn, kc_ref, vc_ref, position)
    torch.cuda.synchronize()
    assert decode_step_attention.launches == before + 1
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref)


def test_kernel_rejects_what_it_cannot_take(cuda):
    q, kn, vn, kc, vc = _inputs(cuda, 2, 30, torch.float32, seed=0)
    with pytest.raises(ValueError):                     # position past the cache
        decode_step_attention(q, kn, vn, kc, vc, 30)
    with pytest.raises(ValueError):                     # T > 32
        big = torch.zeros(2, 8, 33, 72, device=cuda)
        decode_step_attention(q, kn, vn, big, big.clone(), 0)
    with pytest.raises(TypeError):                      # mixed dtypes
        decode_step_attention(q.half(), kn, vn, kc, vc, 0)
    with pytest.raises(ValueError):                     # not contiguous
        decode_step_attention(q, kn, vn, kc.transpose(1, 2).contiguous().transpose(1, 2), vc, 0)
    with pytest.raises(ValueError):                     # Dh not whole 16-byte vectors
        odd = [torch.zeros(2, 8, 70, device=cuda) for _ in range(3)]
        cache = torch.zeros(2, 8, 30, 70, device=cuda)
        decode_step_attention(*odd, cache, cache.clone(), 0)
