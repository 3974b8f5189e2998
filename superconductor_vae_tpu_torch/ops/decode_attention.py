"""Decode-step self-attention with an in-place KV-cache update (kernel K1).

Port of ops/pallas_decode.py: the Pallas TPU kernel ``decode_step_attention``
becomes the CUDA kernel in ``csrc/decode_attention.cu`` (its note gives the
design and the bound), built by ``nvcc`` and called through ``ctypes``.

For every batch row and head the call writes the new K/V row at
``position`` into the ``[B, H, T, Dh]`` caches, IN PLACE, then attends the
single query over cache slots ``<= position`` with float32 accumulation and
a 1/sqrt(Dh) scale, and returns the output in the query's dtype.

Like the TPU kernel, the kernel takes any T and any ``0 <= position < T``.
It takes Dh up to 256 (``MAX_DH``; the TPU kernel has no cap), in either
dtype, including a Dh that is not a whole number of 16-byte vectors: that
runs in a kernel instance with narrower loads, since the caches are written
in place and cannot be zero-padded.

``decode_step_attention`` runs the plain PyTorch version
(``decode_step_attention_ref``) for tensors on the CPU and the kernel for
tensors on a CUDA device; there is no fallback from the one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import load

_NEG_INF = -1e30
MAX_DH = 256         # the kernel's widest instance
_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def decode_step_attention_ref(q, k_new, v_new, k_cache, v_cache,
                              position: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_copy_`` of the new rows into the
    caches (in place), then masked softmax attention in float32.

    q, k_new, v_new: [B, H, Dh]; k_cache, v_cache: [B, H, T, Dh].
    Returns [B, H, Dh] in q's dtype."""
    # a fill, not a copy from the host: no wait on the device
    idx = torch.full((1,), position, dtype=torch.long, device=k_cache.device)
    k_cache.index_copy_(2, idx, k_new[:, :, None, :])
    v_cache.index_copy_(2, idx, v_new[:, :, None, :])
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bhd,bhtd->bht', q.float(), k_cache.float()) * scale
    t_pos = torch.arange(k_cache.shape[2], device=k_cache.device)
    s = s.masked_fill(t_pos > position, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum('bht,bhtd->bhd', p, v_cache.float())
    return o.to(q.dtype)


def bind(lib: ctypes.CDLL) -> dict:
    """{dtype: C entry point} of a library built from csrc/decode_attention.cu."""
    fns = {}
    for dt, suffix in _SUFFIX.items():
        fn = getattr(lib, f'sc_decode_attention_{suffix}')
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dt] = fn
    return fns


@functools.cache
def _launchers():
    return bind(load('decode_attention'))


def _check(q, k_new, v_new, k_cache, v_cache, position):
    tensors = (q, k_new, v_new, k_cache, v_cache)
    if any(t.device != q.device for t in tensors):
        raise ValueError('decode_step_attention: tensors on different devices')
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype for t in tensors):
        raise TypeError('decode_step_attention: all tensors must be float32 '
                        f'or all bfloat16, got {[t.dtype for t in tensors]}')
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError('decode_step_attention: q/k_new/v_new must be '
                         '[B, H, Dh] and the caches [B, H, T, Dh]')
    b, h, dh = q.shape
    t = k_cache.shape[2]
    if (k_new.shape != q.shape or v_new.shape != q.shape
            or k_cache.shape != (b, h, t, dh) or v_cache.shape != k_cache.shape):
        raise ValueError(
            'decode_step_attention: shapes disagree: '
            f'{[tuple(x.shape) for x in tensors]}')
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError('decode_step_attention: tensors must be contiguous')
    if b * h == 0 or t == 0:
        raise ValueError(f'decode_step_attention: need B*H > 0 and T > 0, '
                         f'got B={b} H={h} T={t}')
    if not isinstance(position, int) or not 0 <= position < t:
        raise ValueError(f'decode_step_attention: position must be an int '
                         f'in [0, {t}), got {position!r}')
    if not 0 < dh <= MAX_DH:
        raise ValueError(f'decode_step_attention: Dh={dh} must be in '
                         f'[1, {MAX_DH}]')
    # rows of whole 16-byte vectors take 16-byte loads; a ragged Dh takes
    # element loads (a layer's slice of a ragged cache may start anywhere)
    align = 16 if (dh * q.element_size()) % 16 == 0 else q.element_size()
    if any(x.data_ptr() % align for x in tensors):
        raise ValueError(f'decode_step_attention: tensors must be {align}-byte '
                         f'aligned at Dh={dh}')


def decode_step_attention(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, position: int) -> torch.Tensor:
    """Writes ``k_new``/``v_new`` [B, H, Dh] into row ``position`` of the
    caches [B, H, T, Dh] IN PLACE and returns the single-query attention
    over slots ``<= position``, [B, H, Dh] in q's dtype.

    CPU tensors take ``decode_step_attention_ref``.  CUDA tensors launch
    the kernel on the current stream (counted in
    ``decode_step_attention.launches``, and by dtype in
    ``decode_step_attention.launches_by_dtype``) or raise: unsupported inputs
    (dtype, shape, layout, Dh > 256) and a failed launch are errors."""
    if q.device.type == 'cpu':
        if any(t.device != q.device for t in (k_new, v_new, k_cache, v_cache)):
            raise ValueError('decode_step_attention: tensors on different devices')
        return decode_step_attention_ref(q, k_new, v_new, k_cache, v_cache,
                                         position)
    if q.device.type != 'cuda':
        raise ValueError(f'decode_step_attention: no kernel for {q.device}')
    _check(q, k_new, v_new, k_cache, v_cache, position)
    b, h, dh = q.shape
    out = torch.empty_like(q)
    fn = _launchers()[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
                 b, h, k_cache.shape[2], dh, position,
                 1.0 / math.sqrt(dh), stream)
    if err:
        raise RuntimeError(f'decode_step_attention: launch failed with '
                           f'cudaError_t {err}')
    decode_step_attention.launches += 1
    decode_step_attention.launches_by_dtype[q.dtype] += 1
    return out


decode_step_attention.launches = 0
decode_step_attention.launches_by_dtype = dict.fromkeys(_SUFFIX, 0)
