"""Causal flash-attention forward (kernel K2) and its dispatcher.

Port of ops/pallas_attention.py: the Pallas TPU kernel ``pallas_attention``
becomes the CUDA kernel in ``csrc/flash_attention.cu`` (its note gives the
design and the bound), built by ``nvcc`` and called through ``ctypes``.
The work is bound by its bytes (q, k, v read once, out written once) at
the shapes the port times.  In both dtypes the kernel runs both products
on the tensor cores (``mma.sync``: bf16, or float32 as three TF32 products
of split operands, 3xTF32) and streams K/V through a two-stage
``cp.async`` ring; it takes Dh up to 256.  A Dh that is not a whole number
of 16-byte vectors (float32: Dh % 4, bf16: Dh % 8) is zero-padded to the
next one in the wrapper, scaled by 1/sqrt(real Dh) and sliced back, as
the TPU kernel pads Dh to 128 lanes (``run_padded``).

``flash_attention`` computes softmax attention over ``[B, T, H, Dh]`` with
float32 accumulation, a 1/sqrt(Dh) scale and a causal mask.  As in the TPU
kernel, the causal predicate always applies, whatever ``causal`` says.
It runs the plain PyTorch version (``flash_attention_ref``) for tensors on
the CPU and the kernel for tensors on a CUDA device; there is no fallback
from the one to the other.

The kernel has no gradient, as the TPU kernel has none: the wrapper raises
when autograd would need one.  No model path calls it.  ``fused_attention``
keeps the JAX dispatch policy: the kernel only for causal self-attention of
``T >= MIN_PALLAS_LEN`` on the accelerator (or when forced), and
``mha_attention`` otherwise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import load
from .attention import causal_mask, mha_attention

MIN_PALLAS_LEN = 128   # below this the plain attention runs (as in the JAX policy)
MAX_DH = {torch.float32: 256, torch.bfloat16: 256}   # the kernel's Dh caps
_NEG_INF = -1e30
_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: causal masked softmax in float32, masked
    scores -1e30, probabilities cast to the input dtype before the P.V
    product (as the kernel does), division by max(l, 1e-30).  ``scale``
    multiplies the scores; by default 1/sqrt(Dh).

    q, k, v: [B, T, H, Dh] -> [B, T, H, Dh] in q's dtype."""
    t = q.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum('bhqk,bkhd->bhqd', p.to(q.dtype).float(), v.float()) / l
    return o.transpose(1, 2).contiguous().to(q.dtype)


def bind(lib: ctypes.CDLL) -> dict:
    """{dtype: C entry point} of a library built from csrc/flash_attention.cu."""
    fns = {}
    for dt, suffix in _SUFFIX.items():
        fn = getattr(lib, f'sc_flash_attention_{suffix}')
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dt] = fn
    return fns


@functools.cache
def _launchers():
    return bind(load('flash_attention'))


def _check(q, k, v):
    tensors = (q, k, v)
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype for t in tensors):
        raise TypeError('flash_attention: q, k, v must all be float32 or all '
                        f'bfloat16, got {[t.dtype for t in tensors]}')
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError('flash_attention: q, k, v must be [B, T, H, Dh] of one '
                         f'shape, got {[tuple(t.shape) for t in tensors]}')
    b, t, h, dh = q.shape
    if b * t * h == 0:
        raise ValueError(f'flash_attention: empty input {tuple(q.shape)}')
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError('flash_attention: tensors must be contiguous')
    if dh > MAX_DH[q.dtype] or (dh * q.element_size()) % 16:
        raise ValueError(f'flash_attention: Dh={dh} must be <= {MAX_DH[q.dtype]} '
                         f'in {q.dtype} and a whole number of 16-byte vectors')
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError('flash_attention: tensors must be 16-byte aligned')


def run_padded(attn, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """``attn(q, k, v, scale)`` with Dh zero-padded to a whole number of
    16-byte vectors and ``scale`` = 1/sqrt(real Dh); the output sliced back
    to Dh.  Zero columns change neither q.k nor the real output columns."""
    dh = q.shape[-1]
    vec = 16 // q.element_size()
    pad = -dh % vec
    scale = 1.0 / math.sqrt(dh)
    if not pad:
        return attn(q, k, v, scale)
    q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    return attn(q, k, v, scale)[..., :dh].contiguous()


def _launch(q, k, v, scale):
    """One launch of the kernel on q's current stream."""
    _check(q, k, v)
    b, t, h, dh = q.shape
    out = torch.empty_like(q)
    fn = _launchers()[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, h, dh, scale, stream)
    if err:
        raise RuntimeError(f'flash_attention: launch failed with cudaError_t {err}')
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Causal attention of q over k, v ([B, T, H, Dh], one T) ->
    [B, T, H, Dh] in q's dtype.  ``causal`` is accepted and ignored: the
    predicate is always causal, as in the TPU kernel.

    CPU tensors take ``flash_attention_ref``.  CUDA tensors launch the
    kernel on the current stream (counted in ``flash_attention.launches``)
    or raise: unsupported inputs and a failed launch are errors.  A ragged
    Dh is padded (``run_padded``).  Raises when a gradient would be needed
    (the kernel has no backward) and when q and k differ in length (the
    TPU kernel would attend to padded keys there)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError('flash_attention: the kernel has no gradient; call '
                           'it under torch.no_grad() or on tensors that do not '
                           'require grad')
    if q.shape[1] != k.shape[1]:
        raise ValueError(f'flash_attention: q has {q.shape[1]} positions and k '
                         f'{k.shape[1]}; the kernel takes self-attention only')
    if any(t.device != q.device for t in (k, v)):
        raise ValueError('flash_attention: tensors on different devices')
    if q.device.type == 'cpu':
        return flash_attention_ref(q, k, v)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention: no kernel for {q.device}')
    return run_padded(_launch, q, k, v)


flash_attention.launches = 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None, causal: bool = False,
                    force_pallas: bool = False) -> torch.Tensor:
    """Dispatch as the JAX ``fused_attention``: the kernel for causal
    self-attention with ``T >= MIN_PALLAS_LEN`` on CUDA tensors (the
    port's counterpart of the TPU backend), or whenever ``force_pallas``;
    only with ``mask is None``.  Otherwise ``mha_attention``, with the
    causal mask when ``causal``."""
    tq, tk = q.shape[1], k.shape[1]
    use_kernel = force_pallas or (
        causal and tq == tk and tq >= MIN_PALLAS_LEN and q.device.type == 'cuda')
    if use_kernel and mask is None:
        return flash_attention(q, k, v, causal=True)
    if causal and mask is None:
        mask = causal_mask(tq, device=q.device)
    return mha_attention(q, k, v, mask)
