"""Layer primitives with flax's ``dtype`` semantics: a compute dtype apart
from the float32 parameters.

The JAX package builds every layer with ``dtype=`` (the compute dtype) and
flax's default ``param_dtype`` float32, so a bf16 model keeps float32
parameters, gradients and AdamW moments and computes in bf16.  These
primitives do the same, with the casts written out:

- ``Dense``: input, weight and bias cast to the compute dtype, then the
  product (flax ``Dense``: ``promote_dtype(inputs, kernel, bias,
  dtype=self.dtype)``);
- ``LayerNorm``: mean and variance of the input promoted to float32, the
  normalised, scaled and shifted output in float32, cast to the compute
  dtype at the end (flax ``LayerNorm``: ``_compute_stats`` and
  ``_normalize`` with ``force_float32_reductions``);
- ``Embed``: the rows of the table, cast to the compute dtype (flax
  ``Embed`` casts the whole table and takes the rows: the same values);
- ``gelu``: exact (erf) GELU in the input's dtype.

Each is a subclass of its ``torch.nn`` counterpart, so parameter names and
``models/init.py`` are unchanged.  With a float32 compute dtype every cast
is the identity, and is not called.

A rollout runs the same weights at every decode step without a gradient;
``cast_weights_once`` casts each ``Dense``'s weights once for the whole of
it, as XLA hoists the convert out of its decode scan.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5
PARAM_DTYPE = torch.float32


def gelu(x):
    return F.gelu(x)            # exact erf GELU, as the JAX package's _gelu


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, device=device, dtype=PARAM_DTYPE)
        self.dtype = dtype
        self.frozen = None      # (weight, bias) cast once, see cast_weights_once

    def weights(self):
        """(weight, bias) in the compute dtype: the parameters in float32,
        else their casts, or the copies cast once (``cast_weights_once``)."""
        if self.dtype == PARAM_DTYPE:
            return self.weight, self.bias
        if self.frozen is None:
            return self.weight.to(self.dtype), self.bias.to(self.dtype)
        if torch.is_grad_enabled():
            raise RuntimeError('Dense: weights cast once (cast_weights_once) '
                               'carry no gradient')
        return self.frozen

    def forward(self, x):
        if self.dtype == PARAM_DTYPE:
            return F.linear(x, self.weight, self.bias)
        w, b = self.weights()
        return F.linear(x.to(self.dtype), w, b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5) with float32 parameters and statistics,
    returning ``dtype``."""

    def __init__(self, features: int, device=None, dtype=torch.float32):
        super().__init__(features, eps=LN_EPS, device=device, dtype=PARAM_DTYPE)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype == PARAM_DTYPE:
            return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return F.layer_norm(x.to(PARAM_DTYPE), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class Embed(nn.Embedding):
    """``nn.Embedding`` with a float32 table, returning rows in ``dtype``."""

    def __init__(self, num: int, features: int, device=None, dtype=torch.float32):
        super().__init__(num, features, device=device, dtype=PARAM_DTYPE)
        self.dtype = dtype

    def forward(self, idx):
        out = F.embedding(idx, self.weight)
        return out if self.dtype == PARAM_DTYPE else out.to(self.dtype)


@contextlib.contextmanager
def cast_weights_once(module: nn.Module):
    """While entered, every ``Dense`` of ``module`` whose compute dtype is
    not float32 uses a copy of its weight and bias cast once on entry,
    instead of casting them at every call.  For forward passes without
    gradient only: a ``Dense`` called with grad enabled inside raises."""
    dense = [m for m in module.modules()
             if isinstance(m, Dense) and m.dtype != m.weight.dtype]
    with torch.no_grad():
        for m in dense:
            m.frozen = (m.weight.to(m.dtype), m.bias.to(m.dtype))
    try:
        yield module
    finally:
        for m in dense:
            m.frozen = None


@contextlib.contextmanager
def eval_mode(*modules: nn.Module):
    """The modules in eval mode inside; each back in the mode it had."""
    modes = [m.training for m in modules]
    try:
        for m in modules:
            m.eval()
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)
